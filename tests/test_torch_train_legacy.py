"""The port's legacy per-transcript trainer (ContinuousTrainer(fused=False):
_stats_pass / _centered_m2_pass, _stats_pass_bw /
_centered_m2_pass_weighted, the per-transcript silence bootstrap) against
the JAX package's fused=False trainer, and against the port's own fused
trainer, on the CPU with tests/test_fused_training.py's cases: plain,
silence bootstrap, "band" topology, ragged sentences with an odd utterance
count, Baum-Welch, and state ties.

Tolerances are tests/test_fused_training.py's: parameters within atol 2e-5 /
rtol 1e-4 (Baum-Welch against the fused trainer: atol 5e-5, as JAX holds
its own pair) with -inf at the same places, and the same iteration count.
"""
import numpy as np
import pytest

from cs304_tpu.models.train_continuous import (
    ContinuousTrainConfig as JConfig,
    ContinuousTrainer as JTrainer,
)
from cs304_tpu_torch.models.train_continuous import (
    ContinuousTrainConfig,
    ContinuousTrainer,
    HMMTrainMeanFail,
)
from test_torch_train_continuous import _copy
from test_torch_train_fused import jax_models, make_corpus, make_models
from torch_poison import KERNEL_POISONS, differing_cells, plain_run, poisoned
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

CASES = {  # name -> (transcripts, utterances each, corpus seed, config, tol vs fused)
    "plain": (["12", "321", "13"], 5, 1, {}, 2e-5),
    "bootstrap": (["12", "321"], 6, 3, {"silence_bootstrap": True}, 2e-5),
    "band": (["12", "321"], 4, 5, {"cross_word": "band"}, 2e-5),
    "ragged": (["1", "32", "123", "2131"], 3, 7, {}, 2e-5),
    "baum_welch": (["12", "321", "13"], 5, 17, {"update": "baum_welch"}, 5e-5),
}
TIES = {("1", 0): "a", ("2", 0): "a", ("3", 4): "b", ("1", 4): "b"}


def _assert_params_match(a, b, tol=2e-5):
    for name in ("means_g", "covs_g", "log_a_g"):
        x, y = getattr(a, name), getattr(b, name)
        assert (np.isfinite(x) == np.isfinite(y)).all(), name
        fin = np.isfinite(x)
        np.testing.assert_allclose(x[fin], y[fin], atol=tol, rtol=1e-4, err_msg=name)


def _cfg(kw, fused, cls=ContinuousTrainConfig):
    base = dict(max_iterations=4, silence_bootstrap=False, cov_reg=0.05,
                length_multiple=16)
    return cls(fused=fused, **{**base, **kw})


def _corpus(case):
    transcripts, n_per, seed, _kw, _tol = CASES[case]
    models = make_models(seed=0)
    labeled = make_corpus(models, transcripts, n_per, seed=seed)
    if case == "ragged":
        labeled["1"] = labeled["1"][:2]  # an odd utterance count
    return models, labeled


@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_matches_jax_legacy_and_port_fused(case):
    models, labeled = _corpus(case)
    kw, tol = CASES[case][3], CASES[case][4]
    jt = JTrainer(jax_models(models), _cfg(kw, False, JConfig))
    n_jax = jt.train(labeled)
    legacy = ContinuousTrainer(_copy(models), _cfg(kw, False), device="cpu")
    n_legacy = legacy.train(labeled)
    fused = ContinuousTrainer(_copy(models), _cfg(kw, True), device="cpu")
    n_fused = fused.train(labeled)
    assert n_legacy == n_jax == n_fused
    _assert_params_match(legacy, jt)
    _assert_params_match(legacy, fused, tol)


def test_legacy_with_state_and_transition_ties():
    """Tie pooling on the host (_pool_np) matches JAX's legacy spine and the
    port's fused one."""
    models, labeled = _corpus("plain")
    trans_ties = {"1": "w", "2": "w"}
    jt = JTrainer(jax_models(models), _cfg({}, False, JConfig), state_ties=TIES,
                  transition_ties=trans_ties)
    n_jax = jt.train(labeled)
    out = {}
    for fused in (False, True):
        tr = ContinuousTrainer(_copy(models), _cfg({}, fused), state_ties=TIES,
                               transition_ties=trans_ties, device="cpu")
        out[fused] = (tr.train(labeled), tr)
    assert out[False][0] == n_jax == out[True][0]
    _assert_params_match(out[False][1], jt)
    _assert_params_match(out[False][1], out[True][1])
    legacy = out[False][1]
    i1, i2 = legacy.label_index["1"], legacy.label_index["2"]
    np.testing.assert_array_equal(legacy.means_g[i1, 0], legacy.means_g[i2, 0])


def test_legacy_checkpointed_run_and_empty_state_fail(tmp_path):
    """checkpoint_dir saves the legacy trainer's state each iteration (it
    resumes to the same parameters); a label no transcript uses raises
    HMMTrainMeanFail under on_empty_state="fail", as JAX's legacy spine."""
    models, labeled = _corpus("plain")
    tr = ContinuousTrainer(_copy(models), _cfg({}, False), device="cpu")
    n = tr.train(labeled, checkpoint_dir=str(tmp_path))
    again = ContinuousTrainer(_copy(models), _cfg({}, False), device="cpu")
    assert again.resume(str(tmp_path)) == n
    _assert_params_match(tr, again, tol=0)
    only12 = {"12": labeled["12"]}
    with pytest.raises(HMMTrainMeanFail):
        ContinuousTrainer(_copy(models), _cfg({"on_empty_state": "fail"}, False),
                          device="cpu").train(only12)


def test_mesh_with_legacy_still_raises():
    """The legacy trainer is single-host: mesh= with fused=False raises the
    JAX trainer's ValueError, before the mesh is looked at."""
    models, _ = _corpus("plain")
    with pytest.raises(ValueError, match="fused=True") as got:
        ContinuousTrainer(_copy(models), _cfg({}, False), mesh=object(), device="cpu")
    with pytest.raises(ValueError) as want:
        JTrainer(jax_models(models), _cfg({}, False, JConfig), mesh=object())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("transcript", ["321", "13"])
def test_stats_passes_match_jax_passes(transcript):
    """The legacy passes themselves, on one transcript's batch: _stats_pass's
    integer counts, transition counts and paths equal to JAX's _stats_pass,
    sums within atol 1e-3 / rtol 1e-5 (float32 sums of ~60 frames of
    magnitude ~10 in other orders); _centered_m2_pass within rtol 1e-4 /
    atol 1e-3 of JAX's on the same paths and means."""
    _stats_passes_vs_jax(transcript)


@pytest.mark.parametrize("poison", KERNEL_POISONS)
def test_stats_passes_on_poisoned_memory_match_jax_passes(poison):
    """_m2_per_slot's second moments (and the trellis' backpointers) are
    torch.empty allocations: on memory filled with a poison the passes stay
    within the bounds above, and the second moments equal those computed on
    memory filled with another pattern in every bit."""
    with poisoned(poison):
        got = _stats_passes_vs_jax("13")
    assert differing_cells(got, plain_run(_stats_passes_vs_jax, "13")) == 0


def _stats_passes_vs_jax(transcript):
    """test_stats_passes_match_jax_passes' checks -> the port's m2."""
    import torch

    from cs304_tpu.models import train_continuous as jtc
    from cs304_tpu_torch.models import train_continuous as ttc

    models, labeled = _corpus("plain")
    tr = ContinuousTrainer(_copy(models), _cfg({}, False), device="cpu")
    item = tr._prepare_batches({transcript: labeled[transcript]})[0]
    args = tr._sentence_args(item["topo"])
    n_lab, s_max = len(tr.labels), tr.s_max
    got = ttc._stats_pass(*args, item["batch"], item["lengths"], n_lab, s_max)
    batch_np, lengths_np = item["batch"].numpy(), item["lengths"].numpy()
    want = [np.asarray(x) for x in jtc._stats_pass(
        *args, batch_np, lengths_np, num_labels=n_lab, s_max=s_max)]
    counts, sums, trans, paths = (x.numpy() for x in got)
    np.testing.assert_array_equal(paths, want[3])
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_array_equal(trans, want[2])
    assert counts.sum() == lengths_np.sum() and trans.sum() > 0
    np.testing.assert_allclose(sums, want[1], rtol=1e-5, atol=1e-3)
    topo = item["topo"]
    means = tr.means_g + 0.5
    m2 = ttc._centered_m2_pass(means, topo.lab_of_state, topo.loc_of_state,
                               item["batch"], item["lengths"], got[3], n_lab, s_max)
    want_m2 = jtc._centered_m2_pass(means, topo.lab_of_state, topo.loc_of_state,
                                    batch_np, lengths_np, want[3],
                                    num_labels=n_lab, s_max=s_max)
    np.testing.assert_allclose(m2.numpy(), np.asarray(want_m2), rtol=1e-4, atol=1e-3)
    assert isinstance(got[0], torch.Tensor) and got[0].dtype == torch.float32
    return m2
