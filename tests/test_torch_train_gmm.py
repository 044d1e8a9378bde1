"""Embedded GMM training in the port against cs304_tpu's
(models/train_continuous_gmm.py): fused_gmm_iteration, both loops of
GMMContinuousTrainer ("keep": the device loop, fused_gmm_train_run; "fail":
the step loop), promote_to_gmm, the K = 1 reduction to the single-Gaussian
fused trainer (as tests/test_embedded_gmm.py:65 holds the JAX package) and
the empty-state failure. The corpus is test_torch_train_fused.py's tiny one.

Tolerances, the same inputs going through both: paths, state counts'
integer parts, converged flags and iteration counts exactly equal; mixture
counts within rtol 1e-5 / atol 1e-5 (soft responsibilities); means within
rtol 1e-5 / atol 1e-5, covariances within rtol 1e-4 / atol 1e-5, weights
within atol 1e-6 and log_a within atol 1e-6 (-inf at the same places) after
one iteration. After a trainer's three iterations the soft responsibilities
have fed the one-iteration difference back twice: means within rtol 1e-4 /
atol 5e-5, covariances within rtol 1e-3 / atol 1e-4, weights within
atol 5e-5 (test_embedded_gmm.py holds its K = 1 comparison about so), log_a
(integer counts) still within atol 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.models import train_continuous_gmm as jg
from cs304_tpu.models import train_fused as jf
from cs304_tpu.models.gmm_hmm import GMMWordHMM as JGMMWordHMM
from cs304_tpu.models.train_continuous import insert_silence as j_insert_silence
from cs304_tpu_torch.models import train_continuous_gmm as tg
from cs304_tpu_torch.models import train_fused as tf
from cs304_tpu_torch.models.gmm_hmm import GMMWordHMM
from cs304_tpu_torch.models.train_continuous import (
    ContinuousTrainConfig,
    ContinuousTrainer,
    HMMTrainMeanFail,
    insert_silence,
)
from test_torch_train_fused import TABLES, _assert_params, jax_models, make_corpus, make_models


def jax_gmm(models):
    return {k: JGMMWordHMM(label=v.label, means=v.means.copy(),
                           covariances=v.covariances.copy(), weights=v.weights.copy(),
                           log_a=v.log_a.copy())
            for k, v in models.items()}


def _assert_gmm(want, got, what="", trained=False):
    (wm, wc, ww, wa), (gm, gc, gw, ga) = want, got
    if not trained:
        np.testing.assert_allclose(gw, ww, rtol=0, atol=1e-6, err_msg=f"weights {what}")
        _assert_params((wm, wc, wa), (gm, gc, ga), what)
        return
    np.testing.assert_allclose(gw, ww, rtol=0, atol=5e-5, err_msg=f"weights {what}")
    np.testing.assert_allclose(gm, wm, rtol=1e-4, atol=5e-5, err_msg=f"means {what}")
    np.testing.assert_allclose(gc, wc, rtol=1e-3, atol=1e-4, err_msg=f"covs {what}")
    np.testing.assert_array_equal(np.isfinite(wa), np.isfinite(ga), err_msg=what)
    fin = np.isfinite(wa)
    np.testing.assert_allclose(ga[fin], wa[fin], rtol=0, atol=1e-6, err_msg=f"log_a {what}")


@pytest.fixture(scope="module")
def gmm_setup():
    base = make_models(seed=0)
    labeled = make_corpus(base, ["12", "3", "21"], 3, seed=1)
    models = tg.promote_to_gmm(base, 2, jitter=0.5, seed=4)
    trainer = tg.GMMContinuousTrainer(models, device="cpu")
    jc = jf.prepare_fused_corpus(labeled, trainer.state_counts, trainer.label_index,
                                 j_insert_silence, 32, chunk_utts=32)
    tc = tf.prepare_fused_corpus(labeled, trainer.state_counts, trainer.label_index,
                                 insert_silence, 32, chunk_utts=32, device="cpu")
    return dict(base=base, labeled=labeled, models=models, trainer=trainer, jc=jc, tc=tc)


def test_promote_to_gmm_bitwise():
    base = make_models(seed=5)
    want = jg.promote_to_gmm(jax_models(base), 3, jitter=0.7, seed=2)
    got = tg.promote_to_gmm(base, 3, jitter=0.7, seed=2)
    assert sorted(want) == sorted(got)
    for label in want:
        for name in ("means", "covariances", "weights", "log_a"):
            np.testing.assert_array_equal(getattr(want[label], name),
                                          getattr(got[label], name), err_msg=name)
    with pytest.raises(ValueError):
        tg.promote_to_gmm(got, 2)


def test_one_fused_gmm_iteration_matches_jax(gmm_setup):
    tr, jc, tc = gmm_setup["trainer"], gmm_setup["jc"], gmm_setup["tc"]
    params = (tr.means_g, tr.covs_g, tr.weights_g, tr.log_a_g, tr._slot_used())
    kw = dict(cov_reg=0.05, rtol=1e-5, atol=1e-8, num_labels=len(tr.labels),
              s_max=tr.s_max, num_mix=tr.k, cross_word="exit_only")
    want = [np.asarray(w) for w in jg.fused_gmm_iteration(
        *(jnp.asarray(p) for p in params), *(getattr(jc, n) for n in TABLES[3:]),
        jc.batch, jc.lengths, jc.topo_id, **kw)]
    got = [g.numpy() for g in tg.fused_gmm_iteration(
        *(torch.from_numpy(p) for p in params), *(getattr(tc, n) for n in TABLES[3:]),
        tc.batch, tc.lengths, tc.topo_id, **kw)]
    lengths = tc.lengths.numpy()
    for k in np.ndindex(*lengths.shape):
        np.testing.assert_array_equal(want[6][k][: lengths[k]], got[6][k][: lengths[k]])
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-5)  # counts
    np.testing.assert_array_equal(want[4].sum(-1).round(), got[4].sum(-1).round())
    np.testing.assert_array_equal(want[5], got[5])  # converged
    _assert_gmm(want[:4], got[:4])


@pytest.mark.parametrize("empty", ["keep", "fail"])
def test_gmm_trainer_matches_jax(gmm_setup, empty):
    cfg = dict(max_iterations=3, cov_reg=0.05, on_empty_state=empty)
    jt = jg.GMMContinuousTrainer(jax_gmm(gmm_setup["models"]),
                                 jg.GMMContinuousTrainConfig(**cfg))
    tt = tg.GMMContinuousTrainer(gmm_setup["models"], tg.GMMContinuousTrainConfig(**cfg),
                                 device="cpu")
    assert tt.train(gmm_setup["labeled"]) == jt.train(gmm_setup["labeled"])
    jm, tm = jt.models(), tt.models()
    for label in jm:
        assert isinstance(tm[label], GMMWordHMM)
        _assert_gmm(*[(m[label].means, m[label].covariances, m[label].weights,
                       m[label].log_a) for m in (jm, tm)], what=label, trained=True)


def test_k1_matches_single_gaussian_fused():
    """K = 1 GMM training reproduces the fused single-Gaussian trainer (the
    responsibilities are identically 1), at test_embedded_gmm.py's
    tolerances."""
    models = make_models(seed=7)
    labeled = make_corpus(models, ["12", "21"], 4, seed=8)
    tr1 = ContinuousTrainer(models, ContinuousTrainConfig(
        max_iterations=3, silence_bootstrap=False, cov_reg=0.05, length_multiple=16),
        device="cpu")
    n1 = tr1.train(labeled)
    trk = tg.GMMContinuousTrainer(tg.promote_to_gmm(models, 1, jitter=0.0),
                                  tg.GMMContinuousTrainConfig(max_iterations=3, cov_reg=0.05,
                                                              length_multiple=16),
                                  device="cpu")
    assert trk.train(labeled) == n1
    np.testing.assert_allclose(trk.means_g[:, :, 0], tr1.means_g, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(trk.covs_g[:, :, 0], tr1.covs_g, atol=5e-5, rtol=1e-3)
    fin = np.isfinite(tr1.log_a_g)
    assert (np.isfinite(trk.log_a_g) == fin).all()
    np.testing.assert_allclose(trk.log_a_g[fin], tr1.log_a_g[fin], atol=2e-5, rtol=1e-4)


def test_empty_state_fail_raises():
    models = tg.promote_to_gmm(make_models(seed=4), 2)
    labeled = make_corpus(make_models(seed=4), ["12"], 3, seed=5)  # "3" never appears
    with pytest.raises(HMMTrainMeanFail):
        tg.GMMContinuousTrainer(models, tg.GMMContinuousTrainConfig(on_empty_state="fail"),
                                device="cpu").train(labeled)
    # mesh= takes a data-parallel mesh (tests/test_torch_parallel_train.py).
    with pytest.raises(TypeError, match="DeviceMesh"):
        tg.GMMContinuousTrainer(models, mesh=object(), device="cpu")
    # ContinuousTrainer given GMM models fails in train() with a ValueError,
    # as the JAX trainer does, and names the trainer to use.
    with pytest.raises(ValueError, match="GMMContinuousTrainer"):
        ContinuousTrainer(models, device="cpu").train(labeled)
