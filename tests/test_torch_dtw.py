"""The port's template DTW (ops/dtw.py) against the JAX package's, on the
CPU, and the column kernel's plain version (dtw_columns_plain) against
JAX's lax.scan.

Tolerances: the column recursion on the SAME distances is bitwise JAX's
(a min, a compare and one float32 add a cell, the prune threshold
prev_min * (1 + factor) in JAX's order) with and without pruning;
pairwise_euclidean within rtol 1e-5 / atol 1e-5 of JAX's (one float32
matmul each, summed in other orders); recognizer costs within rtol 1e-5,
and the same search index.
"""
import numpy as np
import pytest
import torch

from cs304_tpu.ops import dtw as jdtw
from cs304_tpu_torch.ops import dtw as tdtw
from cs304_tpu_torch.ops.cuda.dtw import dtw_columns


def _templates(rng, lengths, d=13):
    return [rng.normal(size=(n, d)).astype(np.float32) for n in lengths]


CASES = {  # name -> (word lengths, sample frames)
    "digits": ([9, 12, 7, 14, 10, 8, 11, 13, 9, 10, 12], 30),
    "l1": ([5, 1, 6, 2], 1),
    "one-frame-words": ([1, 8, 1, 1, 7], 12),
    "single-word": ([6], 10),
}


@pytest.mark.parametrize("factor", [4.0, 0.4, 0.02])
@pytest.mark.parametrize("pruning", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_columns_are_bitwise_jax_on_the_same_distances(case, pruning, factor):
    rng = np.random.default_rng(len(case))
    lengths, n_frames = CASES[case]
    rec = jdtw.DTWRecognizer.from_features(_templates(rng, lengths))
    sample = rng.normal(size=(n_frames, 13)).astype(np.float32)
    dist = np.array(jdtw.pairwise_euclidean(rec.templates, sample))  # (H, L)
    want = np.asarray(jdtw.dtw_multi_template(
        dist, rec._is_first, rec._is_second, rec._end_rows, pruning=pruning,
        pruning_factor=factor))
    got = tdtw.dtw_multi_template(torch.as_tensor(dist), rec._is_first, rec._is_second,
                                  rec._end_rows, pruning=pruning, pruning_factor=factor)
    np.testing.assert_array_equal(got.numpy(), want)
    # The wrapper takes the plain version on CPU tensors, column-major.
    plain = dtw_columns(torch.as_tensor(dist.T.copy()),
                        torch.as_tensor(rec._is_first), torch.as_tensor(rec._is_second),
                        torch.as_tensor(rec._end_rows), pruning, factor)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_pairwise_euclidean_matches_jax(rng):
    a = rng.normal(size=(17, 39)).astype(np.float32)
    b = rng.normal(size=(23, 39)).astype(np.float32)
    got = tdtw.pairwise_euclidean(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdtw.pairwise_euclidean(a, b)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pruning", [True, False])
def test_recognizer_matches_jax(rng, pruning):
    templates = _templates(rng, [8, 10, 6, 9])
    port = tdtw.DTWRecognizer.from_features(templates, pruning=pruning, device="cpu")
    jax = jdtw.DTWRecognizer.from_features(templates, pruning=pruning)
    for k in range(4):
        # A time-warped noisy copy of template k: the search must find it.
        sample = (np.repeat(templates[k], 2, axis=0)
                  + rng.normal(0, 0.1, (2 * len(templates[k]), 13))).astype(np.float32)
        np.testing.assert_allclose(port.distances(sample), jax.distances(sample), rtol=1e-5)
        idx, cost = port.search(sample)
        assert idx == jax.search(sample)[0] == k
        assert cost == pytest.approx(jax.search(sample)[1], rel=1e-5)


@pytest.mark.parametrize("lengths", [[0], [4, 0, 3], [3, 0]])
def test_recognizer_rejects_an_empty_template(rng, lengths):
    """The column kernel gathers each word's last row unchecked: a word of
    no frames (its last row outside [0, H)) is refused up front."""
    with pytest.raises(ValueError, match="at least one frame"):
        tdtw.DTWRecognizer.from_features(_templates(rng, lengths), device="cpu")
