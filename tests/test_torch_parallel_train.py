"""The port's trainers over a data-parallel mesh (ContinuousTrainer,
GMMContinuousTrainer and the phone tier with ``mesh=``) against the JAX
package's on its 8-device virtual CPU mesh.

As in tests/test_torch_parallel.py, the port runs in one spawned group of 4
gloo ranks (tests/torch_ranks.py), every rank on the same inputs, made with
numpy from seeds. The corpus has 6 utterances: the port pads it to 4 chunks
of 8 (ranks 1-3 hold padding only) and JAX to 8, so the padding path runs on
both. Checked:

- the 4 ranks bitwise identical to each other;
- Viterbi and Baum-Welch (the device loop), and Viterbi with the silence
  bootstrap and a state folder (the per-iteration loop, rank 0 writing the
  state): the same iteration count as JAX's mesh trainer and the parameters
  within tests/test_fused_training.py:74-80's bound (rtol 1e-4, atol 2e-5,
  -inf at the same places);
- the K=2 GMM trainer, in its device loop and (on_empty_state="fail") its
  per-iteration loop: iterations equal, parameters within the bound of a
  multi-iteration GMM run (tests/test_torch_lexicon.py GMM_TOL: means rtol
  1e-4 / atol 5e-5, covariances rtol 1e-3 / atol 1e-4, weights atol 5e-5);
- train_phone_models(mesh=) on a 4-phone lexicon: iterations equal, phone
  models within rtol 1e-4 / atol 1e-5 (tests/test_torch_lexicon.py).
"""
import os

import numpy as np
import pytest
import torch

from cs304_tpu_torch.models.hmm import WordHMM, uniform_forward_log_a
from torch_ranks import run_ranks, same_bits
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

WORLD = 4
D = 4
GMM_TOL = {"means": (1e-4, 5e-5), "covariances": (1e-3, 1e-4), "weights": (0, 5e-5),
           "log_a": (1e-4, 2e-5)}
LEXICON = {"aa": ("p0", "p1"), "bb": ("p2", "p3"), "cc": ("p1", "p2")}
PHONE_TRANSCRIPTS = (("aa",), ("bb", "cc"), ("cc", "aa"))


def _hmm(label, s, rng):
    a = rng.normal(size=(s, D, 3)).astype(np.float32) * 0.2
    return WordHMM(label=label, means=rng.normal(size=(s, D)).astype(np.float32) * 3,
                   covariances=a @ np.transpose(a, (0, 2, 1)) + 0.4 * np.eye(D, dtype=np.float32),
                   log_a=uniform_forward_log_a(s))


def make_models(seed=0, labels=("1", "2", "S")):
    rng = np.random.default_rng(seed)
    return {label: _hmm(label, 3 if label == "S" else 5, rng) for label in labels}


def _walk(models, units, rng):
    """Frames that visit each unit's states in order, 2-4 frames a state."""
    frames = [models[u].means[s] + rng.normal(0, 0.5, size=(rng.integers(2, 5), D))
              for u in units for s in range(models[u].num_states)]
    return np.concatenate(frames).astype(np.float32)


def make_corpus(models, transcripts=("12", "21"), n_per=3, seed=1):
    """6 utterances: each transcript's silence-interleaved sentence walked."""
    rng = np.random.default_rng(seed)
    return {tr: [_walk(models, "S" + "S".join(tr) + "S", rng) for _ in range(n_per)]
            for tr in transcripts}


def phone_setup(seed=4):
    rng = np.random.default_rng(seed)
    phones = {p: _hmm(p, 3, rng) for p in ("p0", "p1", "p2", "p3", "S")}
    labeled = {}
    for tr in PHONE_TRANSCRIPTS:
        units = ["S"] + [u for w in tr for u in (*LEXICON[w], "S")]
        labeled[tr] = [_walk(phones, units, rng) for _ in range(2)]
    return phones, labeled


def _trainer_cfg(**kw):
    return dict(dict(max_iterations=4, silence_bootstrap=False, cov_reg=0.05,
                     length_multiple=8), **kw)


TRAINER_RUNS = {
    "viterbi": _trainer_cfg(),
    "baum_welch": _trainer_cfg(update="baum_welch"),
    "bootstrap_state": _trainer_cfg(silence_bootstrap=True),
}


# -- what every rank runs ----------------------------------------------------------

def trainer_case(mesh, payload):
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig, ContinuousTrainer

    labeled = make_corpus(make_models())
    out = {}
    for name, cfg in TRAINER_RUNS.items():
        tr = ContinuousTrainer(make_models(), ContinuousTrainConfig(**cfg), mesh=mesh)
        state = payload["state"] if name == "bootstrap_state" else None
        n = tr.train(labeled, checkpoint_dir=state)
        out[name] = (n, tr.means_g, tr.covs_g, tr.log_a_g)
    return out


def gmm_case(mesh, payload):
    from cs304_tpu_torch.models.train_continuous_gmm import (
        GMMContinuousTrainConfig,
        GMMContinuousTrainer,
        promote_to_gmm,
    )

    labeled = make_corpus(make_models())
    out = {}
    for policy in ("keep", "fail"):
        tr = GMMContinuousTrainer(
            promote_to_gmm(make_models(), 2),
            GMMContinuousTrainConfig(max_iterations=3, cov_reg=0.05, on_empty_state=policy),
            mesh=mesh)
        n = tr.train(labeled)
        out[policy] = (n, {k: (m.means, m.covariances, m.weights, m.log_a)
                           for k, m in tr.models().items()})
    return out


def phones_case(mesh, payload):
    from cs304_tpu_torch.models.lexicon import Lexicon, train_phone_models
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig

    phones, labeled = phone_setup()
    models, n = train_phone_models(
        phones, labeled, Lexicon(dict(LEXICON)),
        config=ContinuousTrainConfig(max_iterations=3, cov_reg=0.1), mesh=mesh, device="cpu")
    return n, {k: (m.means, m.covariances, m.log_a) for k, m in models.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    folder = tmp_path_factory.mktemp("ranks")
    state = str(folder / "state")
    res = run_ranks((trainer_case, gmm_case, phones_case), {"state": state}, WORLD, folder)
    return res, state


def result(ranks, case):
    res, _state = ranks
    first = res[0][case.__name__]
    for rank, other in enumerate(res[1:], 1):
        assert same_bits(other[case.__name__], first), f"rank {rank} differs from rank 0"
    return first


def _close(got, want, rtol, atol, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol, err_msg=what)


def _jax(models):
    from cs304_tpu.models.gmm_hmm import GMMWordHMM as JGMM
    from cs304_tpu.models.hmm import WordHMM as JWordHMM

    return {k: (JGMM(m.label, m.means.copy(), m.covariances.copy(), m.weights.copy(),
                     m.log_a.copy()) if hasattr(m, "weights") else
                JWordHMM(m.label, m.means.copy(), m.covariances.copy(), m.log_a.copy()))
            for k, m in models.items()}


def _jax_mesh():
    from cs304_tpu.parallel.data_parallel import make_mesh

    return make_mesh()


# -- the 4 ranks against JAX's 8-device mesh ------------------------------------------

@pytest.mark.parametrize("name", list(TRAINER_RUNS))
def test_continuous_trainer_mesh_matches_jax(ranks, name, tmp_path):
    from cs304_tpu.models.train_continuous import ContinuousTrainConfig as JConfig
    from cs304_tpu.models.train_continuous import ContinuousTrainer as JTrainer

    n, means, covs, log_a = result(ranks, trainer_case)[name]
    want = JTrainer(_jax(make_models()), JConfig(**TRAINER_RUNS[name]), mesh=_jax_mesh())
    ckpt = str(tmp_path / "jax_state") if name == "bootstrap_state" else None
    assert n == want.train(make_corpus(make_models()), checkpoint_dir=ckpt)
    want.models()  # the device state back to the host
    for got, w, what in ((means, want.means_g, "means"), (covs, want.covs_g, "covs"),
                         (log_a, want.log_a_g, "log_a")):
        _close(got, w, 1e-4, 2e-5, f"{name} {what}")
    if name == "bootstrap_state":
        assert os.listdir(ranks[1]) == ["trainer_state.npz"]  # rank 0's file alone


@pytest.mark.parametrize("policy", ["keep", "fail"])
def test_gmm_trainer_mesh_matches_jax(ranks, policy):
    from cs304_tpu.models.train_continuous_gmm import GMMContinuousTrainConfig as JConfig
    from cs304_tpu.models.train_continuous_gmm import GMMContinuousTrainer as JTrainer
    from cs304_tpu_torch.models.train_continuous_gmm import promote_to_gmm

    n, models = result(ranks, gmm_case)[policy]
    want = JTrainer(_jax(promote_to_gmm(make_models(), 2)),
                    JConfig(max_iterations=3, cov_reg=0.05, on_empty_state=policy),
                    mesh=_jax_mesh())
    assert n == want.train(make_corpus(make_models()))
    for label, m in want.models().items():
        for got, name in zip(models[label], ("means", "covariances", "weights", "log_a")):
            _close(got, getattr(m, name), *GMM_TOL[name], f"{label} {name}")


def test_phone_tier_mesh_matches_jax(ranks):
    import cs304_tpu.models.lexicon as jlx
    from cs304_tpu.models.train_continuous import ContinuousTrainConfig as JConfig

    n, models = result(ranks, phones_case)
    phones, labeled = phone_setup()
    want, want_n = jlx.train_phone_models(
        _jax(phones), labeled, jlx.Lexicon(dict(LEXICON)),
        config=JConfig(max_iterations=3, cov_reg=0.1), mesh=_jax_mesh())
    assert n == want_n
    assert sorted(models) == sorted(want)
    for label, m in want.items():
        for got, name in zip(models[label], ("means", "covariances", "log_a")):
            _close(got, getattr(m, name), 1e-4, 1e-5, f"{label} {name}")
