"""Isolated-word Baum-Welch and forward scoring, the callers of FBD
(ops/forward_backward.py), against the JAX package's models/gmm_hmm.py on
the CPU with the same numpy inputs: one _bw_stats E-step and M-step at
K = 1 and K = 4 mixtures, train_gmm_hmm_baum_welch for two iterations from
one k-means init at K = 1 and K = 4, and GMMWordHMM.forward_score with and
without a length.

Tolerances are tests/test_torch_gmm.py's (_assert_gmm_model): means,
weights and log_a rtol 1e-4 / atol 1e-4 (-inf at the same places),
covariances rtol 1e-3 / atol 1e-4; the statistics' counts the same as the
means', the total log-likelihood and forward scores rtol 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.data.batching import pad_batch as j_pad_batch
from cs304_tpu.models import gmm_hmm as jg
from cs304_tpu.models.train_kmeans import SegmentalKMeansConfig as JKCfg
from cs304_tpu_torch.data.batching import pad_batch
from cs304_tpu_torch.models import gmm_hmm as tg
from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig
from test_torch_gmm import _assert_gmm_model, _close, _gmm_arrays, _word_clips
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

CFG = dict(num_states=4, max_iterations=2, length_multiple=8, cov_reg=0.01)


def _init(k, seed=3):
    """A k-mixture k-means model of the JAX package, the shared init."""
    clips = _word_clips(3, n=8)
    return clips, jg.train_gmm_hmm("7", clips, num_mixtures=k, cfg=JKCfg(**CFG), seed=seed)


@pytest.mark.parametrize("k", [1, 4])
def test_bw_stats_match_jax(k):
    clips, init = _init(k)
    padded = pad_batch(clips, CFG["length_multiple"])
    j_padded = j_pad_batch(clips, CFG["length_multiple"])
    np.testing.assert_array_equal(padded.data, j_padded.data)
    params = (init.means, init.covariances, init.weights, init.log_a)
    want = jg._bw_stats(*(jnp.asarray(x) for x in params), jnp.asarray(j_padded.data),
                        jnp.asarray(j_padded.lengths), CFG["cov_reg"])
    got = tg._bw_stats(*(torch.tensor(np.array(x)) for x in params),
                       torch.as_tensor(padded.data), torch.as_tensor(padded.lengths),
                       CFG["cov_reg"])
    for name, g, w, (rtol, atol) in zip(
            ("means", "covs", "weights", "log_a", "counts", "total_ll"), got, want,
            ((1e-4, 1e-4), (1e-3, 1e-4), (1e-4, 1e-4), (1e-4, 1e-4), (1e-4, 1e-4),
             (1e-5, 0.0))):
        _close(g, w, rtol=rtol, atol=atol, what=f"{name} K={k}")


@pytest.mark.parametrize("k", [1, 4])
def test_baum_welch_training_matches_jax(k):
    clips, init = _init(k)
    want = jg.train_gmm_hmm_baum_welch("7", clips, k, JKCfg(**CFG), init=init)
    got = tg.train_gmm_hmm_baum_welch(
        "7", clips, k, SegmentalKMeansConfig(**CFG),
        init=tg.GMMWordHMM("7", init.means, init.covariances, init.weights, init.log_a),
        device="cpu")
    _assert_gmm_model(want, got, f"baum-welch K={k}")
    assert not np.allclose(got.means, init.means)  # the two iterations moved it


def test_forward_score_matches_jax():
    means, covs, weights, frames = _gmm_arrays(7, s=5, k=4, d=5, pad_last=False)
    log_a = _init(1)[1].log_a[:4, :4].copy()
    log_a = np.pad(log_a, ((0, 1), (0, 1)), constant_values=-np.inf)
    log_a[3, 4] = log_a[4, 4] = np.log(0.5)  # a banded five-state word
    jm = jg.GMMWordHMM("3", means, covs, weights, log_a)
    tm = tg.GMMWordHMM("3", means, covs, weights, log_a)
    for length in (None, 11, 1):
        np.testing.assert_allclose(tm.forward_score(frames, length=length, device="cpu"),
                                   jm.forward_score(frames, length=length), rtol=1e-5)
