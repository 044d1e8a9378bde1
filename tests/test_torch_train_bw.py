"""Embedded Baum-Welch in the port against cs304_tpu's
(models/train_fused.py:_banded_fb_batch, fused_bw_iteration,
fused_train_run(update="baum_welch"), ContinuousTrainer(update=
"baum_welch")), on the tiny corpus of test_torch_train_fused.py.

Tolerances, the same inputs going through both:
  - the sentence forward-backward (FB's plain version): -inf in exactly the
    same cells of alpha, beta and ll; finite cells within rtol 1e-5 /
    atol 1e-4 (XLA and torch compute exp and log apart);
  - one fused_bw_iteration and the trainer: counts within rtol 1e-4 /
    atol 1e-5 (sums of posteriors that XLA and torch exponentiate apart),
    converged flags and iteration
    counts equal, parameters at test_torch_train_fused.py's tolerances
    for the means (rtol 1e-5 / atol 1e-5) and covariances (rtol 1e-4 /
    atol 1e-5), log_a within atol 1e-4 with -inf at the same places. The
    Viterbi trainer's log_a is a ratio of integer counts (atol 1e-6 there);
    here it is a ratio of posteriors exp(alpha + beta - ll), whose exponent
    is a difference of float32 values of size |ll| ~ 1e2..1e3, so XLA's and
    torch's exp and log leave ~1e-5 relative in each posterior.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.models import train_fused as jf
from cs304_tpu.models.train_continuous import (
    ContinuousTrainConfig as JConfig,
    ContinuousTrainer as JTrainer,
)
from cs304_tpu_torch.models import train_fused as tf
from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig, ContinuousTrainer
from cs304_tpu_torch.ops.cuda import trellis_fb
from test_torch_train_fused import (
    TABLES,
    _assert_params,
    jax_models,
    make_corpus,
    make_models,
    setup,  # noqa: F401  (the module fixture)
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _fb_problem(b, t, s, seed, zero_length=False):
    rng = np.random.default_rng(seed)
    log_b = rng.normal(size=(b, t, s)).astype(np.float32) * 2
    cs = [rng.normal(size=(b, s)).astype(np.float32) * 0.5 for _ in range(3)]
    cs[1][:, :1] = -np.inf
    cs[2][:, :2] = -np.inf
    for c in cs[1:]:
        c[rng.random((b, s)) < 0.2] = -np.inf
    log_b[rng.random((b, t, s)) < 0.05] = -np.inf
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    if zero_length:
        lengths[1::3] = 0
        lengths[2] = 1
    n_states = rng.integers(max(1, s - 4), s + 1, size=b).astype(np.int32)
    return log_b, *cs, lengths, n_states


def _assert_fb(want, got):
    for w, g, name in zip(want, got, ("alpha", "beta", "ll")):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape, name
        np.testing.assert_array_equal(np.isfinite(w), np.isfinite(g), err_msg=name)
        assert not np.isnan(g).any(), name
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", [(6, 20, 11, False), (9, 17, 3, True), (5, 1, 7, False),
                                  (4, 12, 2, True)])
def test_banded_fb_batch_matches_jax(case):
    b, t, s, zero = case
    prob = _fb_problem(b, t, s, seed=b * 100 + t, zero_length=zero)
    want = jf._banded_fb_batch(*(jnp.asarray(x) for x in prob))
    got = tf._banded_fb_batch(*(torch.from_numpy(x) for x in prob))
    _assert_fb(want, got)
    # The wrapper on CPU tensors is the same plain version.
    lens = torch.from_numpy(prob[4])
    final = torch.clamp(torch.from_numpy(prob[5]) - 1, min=0).to(torch.int32)
    again = trellis_fb.banded_fb(*(torch.from_numpy(x) for x in prob[:4]), lens, final)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_lse3_matches_jax():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=64).astype(np.float32) * 30 for _ in range(3)]
    for x in xs:
        x[rng.random(64) < 0.4] = -np.inf
    want = np.asarray(jf._lse3(*(jnp.asarray(x) for x in xs)))
    got = tf._lse3(*(torch.from_numpy(x) for x in xs)).numpy()
    np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-5)


def _iteration_args(setup, lib):
    params = (setup["means"], setup["covs"], setup["log_a"], setup["slot_used"])
    corpus = setup["jc"] if lib == "jax" else setup["tc"]
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return (*(conv(p) for p in params), *(getattr(corpus, n) for n in TABLES[3:]),
            corpus.batch, corpus.lengths, corpus.topo_id)


@pytest.mark.parametrize("cross_word", ["exit_only", "band"])
def test_one_fused_bw_iteration_matches_jax(setup, cross_word):
    st = setup["st"]
    kw = dict(cov_reg=0.05, rtol=1e-5, atol=1e-8, num_labels=len(st.labels),
              s_max=st.s_max, cross_word=cross_word)
    want = [np.asarray(w) for w in jf.fused_bw_iteration(*_iteration_args(setup, "jax"), **kw)]
    got = [g.numpy() for g in tf.fused_bw_iteration(*_iteration_args(setup, "torch"), **kw)]
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-5)  # soft counts
    np.testing.assert_array_equal(want[4], got[4])  # converged_l
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5)  # summed log-likelihood
    _assert_params(want[:3], got[:3], cross_word, log_a_atol=1e-4)


def test_bw_fused_train_run_matches_jax(setup):
    """Convergence at rtol 1e-4: at 1e-5 one label of this corpus sits on
    the allclose threshold at the second iteration (converged in one package,
    not in the other, by less than the two packages' float difference)."""
    st = setup["st"]
    kw = dict(cov_reg=0.05, rtol=1e-4, atol=1e-8, num_labels=len(st.labels),
              s_max=st.s_max, cross_word="exit_only", max_iterations=3, update="baum_welch")
    want = jf.fused_train_run(*_iteration_args(setup, "jax"), **kw)
    got = tf.fused_train_run(*_iteration_args(setup, "torch"), **kw)
    assert got[4:] == (int(want[4]), bool(want[5]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-4, atol=1e-5)
    _assert_params([np.asarray(w) for w in want[:3]], [g.numpy() for g in got[:3]],
                   log_a_atol=1e-4)


# Convergence at rtol 1e-4 (see test_bw_fused_train_run_matches_jax): at
# 1e-5 a label of this corpus converges in one package and not the other.
CFG = dict(max_iterations=3, cov_reg=0.05, update="baum_welch", rtol=1e-4)


@pytest.mark.parametrize("empty", ["keep", "fail"])
def test_baum_welch_trainer_matches_jax(empty):
    """Both loops of the trainer: the device loop (fused_train_run) under
    "keep" and the step loop (one fused_bw_iteration a step, the host reading
    counts) under "fail"; the silence bootstrap (a Viterbi alignment) runs
    first in both packages."""
    models = make_models(seed=2)
    labeled = make_corpus(models, ["12", "3", "21"], 3, seed=3)
    cfg = dict(CFG, on_empty_state=empty)
    jt = JTrainer(jax_models(models), JConfig(**cfg))
    tt = ContinuousTrainer(models, ContinuousTrainConfig(**cfg), device="cpu")
    assert tt.train(labeled) == jt.train(labeled)
    jm, tm = jt.models(), tt.models()
    for label in jm:
        _assert_params((jm[label].means, jm[label].covariances, jm[label].log_a),
                       (tm[label].means, tm[label].covariances, tm[label].log_a), label,
                       log_a_atol=1e-4)
