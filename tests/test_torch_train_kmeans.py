"""The port's segmental k-means (models/train_kmeans.py) against cs304_tpu's.

Tolerances, the same inputs going through both: counts exactly equal;
means within rtol 1e-5 / atol 1e-5; covariances within rtol 1e-4 /
atol 1e-5; log_a within atol 1e-6 with -inf at the same places; the same
iteration counts and convergence flags.
"""
import logging

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.models import train_kmeans as jk
from cs304_tpu_torch.models import train_kmeans as tk

D = 5


def _utterances(rng, n, s=5, d=D):
    """n utterances stepping through s well-separated states."""
    centers = rng.normal(size=(s, d)).astype(np.float32) * 4
    out = []
    for _ in range(n):
        frames = [centers[i] + rng.normal(0, 0.3, size=(rng.integers(4, 8), d))
                  for i in range(s)]
        out.append(np.concatenate(frames).astype(np.float32))
    return out


def _assert_close(want, got, what=""):
    wm, wc, wa = (np.asarray(x) for x in want)
    gm, gc, ga = got
    np.testing.assert_allclose(gm, wm, rtol=1e-5, atol=1e-5, err_msg=f"means {what}")
    np.testing.assert_allclose(gc, wc, rtol=1e-4, atol=1e-5, err_msg=f"covs {what}")
    fin = np.isfinite(wa)
    np.testing.assert_array_equal(fin, np.isfinite(ga), err_msg=what)
    np.testing.assert_allclose(ga[fin], wa[fin], rtol=0, atol=1e-6, err_msg=what)


def test_kmeans_step_matches_jax():
    rng = np.random.default_rng(0)
    feats = _utterances(rng, 6)
    cfg = tk.SegmentalKMeansConfig(length_multiple=8)
    means, covs, log_a = tk.init_parameters(feats[0], cfg)
    pad = tk.pad_batch(feats, 8)
    lengths = pad.lengths.copy()
    lengths[-1] = 0  # a length-0 dummy, as the batched trainer pads with
    want = jk.kmeans_step(jnp.asarray(means), jnp.asarray(covs), jnp.asarray(log_a),
                          jnp.asarray(pad.data), jnp.asarray(lengths), 5, 0.001)
    got = tk.kmeans_step(*(torch.from_numpy(x) for x in (means, covs, log_a, pad.data,
                                                         lengths)), 5, 0.001)
    got = [g.numpy() for g in got]
    np.testing.assert_array_equal(np.asarray(want[3]), got[3])  # counts
    _assert_close(want[:3], got[:3])
    np.testing.assert_allclose(got[4], np.asarray(want[4]), rtol=1e-5)


def test_train_word_hmm_matches_jax():
    rng = np.random.default_rng(1)
    feats = _utterances(rng, 5, s=3)
    cfg = jk.SegmentalKMeansConfig(num_states=3, max_iterations=15, length_multiple=8)
    want = jk.train_word_hmm("S", feats, cfg)
    got = tk.train_word_hmm("S", feats, tk.SegmentalKMeansConfig(
        num_states=3, max_iterations=15, length_multiple=8), device="cpu")
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    m_w, m_g = want.model, got.model
    _assert_close((m_w.means, m_w.covariances, m_w.log_a),
                  (m_g.means, m_g.covariances, m_g.log_a))
    # mesh= takes a data-parallel mesh (tests/test_torch_parallel.py).
    with pytest.raises(TypeError, match="DeviceMesh"):
        tk.train_word_hmm("S", feats, mesh=object())


def test_batched_empty_state_fails_like_jax():
    rng = np.random.default_rng(0)  # a corpus on which a state of "3" starves
    feats = {label: _utterances(rng, n) for label, n in (("1", 4), ("2", 6), ("3", 3))}
    kw = dict(num_states=5, max_iterations=12, length_multiple=8)
    with pytest.raises(jk.HMMTrainMeanFail) as want:
        jk.train_digit_models(feats, jk.SegmentalKMeansConfig(**kw))
    with pytest.raises(tk.HMMTrainMeanFail) as got:
        tk.train_digit_models(feats, tk.SegmentalKMeansConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_train_digit_models_batched_matches_jax(caplog):
    rng = np.random.default_rng(2)  # a corpus whose states all keep frames
    # Uneven utterance counts: the batched trainer pads with length-0 rows.
    feats = {label: _utterances(rng, n) for label, n in (("1", 4), ("2", 6), ("3", 3))}
    kw = dict(num_states=5, max_iterations=12, length_multiple=8)
    with caplog.at_level(logging.INFO):
        want = jk.train_digit_models(feats, jk.SegmentalKMeansConfig(**kw))
        got = tk.train_digit_models(feats, tk.SegmentalKMeansConfig(**kw), device="cpu")

    def iterations(pkg):  # the per-model "converged=... after N iters" lines
        return [r.getMessage() for r in caplog.records
                if r.name == f"{pkg}.models.train_kmeans" and "(batched)" in r.getMessage()]

    assert iterations("cs304_tpu_torch") == iterations("cs304_tpu")
    assert len(iterations("cs304_tpu")) == 3
    for label in feats:
        w, g = want[label], got[label]
        _assert_close((w.means, w.covariances, w.log_a),
                      (g.means, g.covariances, g.log_a), label)
