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


def _past_the_old_cap(rng, d=13, integer=False):
    """11 words x 10 templates of 80-100 frames: H past 8,192 rows."""
    lengths = rng.integers(80, 101, 110)
    if integer:
        return [rng.integers(-3, 4, (n, d)).astype(np.float32) for n in lengths]
    return _templates(rng, lengths, d)


@pytest.mark.parametrize("pruning", [True, False])
def test_recognizer_matches_jax_past_8192_rows(rng, pruning):
    templates = _past_the_old_cap(rng)
    assert sum(len(t) for t in templates) > 8192
    port = tdtw.DTWRecognizer.from_features(templates, pruning=pruning, device="cpu")
    jax = jdtw.DTWRecognizer.from_features(templates, pruning=pruning)
    for k in (0, 57, 109):
        # Template k warped to 2/3 of its frames, with noise: the search finds it.
        warped = np.repeat(templates[k], 2, axis=0)[::3]
        sample = (warped + rng.normal(0, 0.1, warped.shape)).astype(np.float32)
        np.testing.assert_allclose(port.distances(sample), jax.distances(sample), rtol=1e-5)
        idx, cost = port.search(sample)
        assert idx == jax.search(sample)[0] == k
        assert cost == pytest.approx(jax.search(sample)[1], rel=1e-5)


@pytest.mark.parametrize("pruning", [True, False])
def test_zero_distance_sample_matches_jax(rng, pruning):
    """The sample is one template's own frames (integer features, so their
    distances are exactly 0): cost 0 for that word in both packages, whose
    prune threshold is then a zero."""
    templates = _past_the_old_cap(rng, integer=True)
    port = tdtw.DTWRecognizer.from_features(templates, pruning=pruning, device="cpu")
    jax = jdtw.DTWRecognizer.from_features(templates, pruning=pruning)
    for k in (3, 88):
        got = port.distances(templates[k])
        np.testing.assert_array_equal(got, jax.distances(templates[k]))
        assert got[k] == 0.0
        assert port.search(templates[k]) == (k, 0.0)


def test_cached_template_norms_leave_distances_bitwise(rng):
    """DTWRecognizer.distances keeps the templates' squared norms and writes
    its distances into 16-byte-aligned rows: the distances, and the costs,
    are bitwise pairwise_euclidean computed in full."""
    templates = _templates(rng, [9, 12, 7, 14, 11])  # H = 53, not a multiple of 4
    rec = tdtw.DTWRecognizer.from_features(templates, device="cpu")
    for n_frames in (1, 23):
        sample = rng.normal(size=(n_frames, 13)).astype(np.float32)
        full = tdtw.pairwise_euclidean(torch.as_tensor(sample), rec._templates)
        kept = tdtw.pairwise_euclidean(torch.as_tensor(sample), rec._templates,
                                       rec._templates_sq, out=torch.empty_like(full))
        assert torch.equal(full, kept)
        want = dtw_columns(full, rec._is_first, rec._is_second, rec._end_rows)
        np.testing.assert_array_equal(rec.distances(sample), want.numpy())


@pytest.mark.parametrize("factor", [4.0, 0.4, -0.5])
@pytest.mark.parametrize("pruning", [True, False])
def test_columns_are_bitwise_jax_on_negative_distances(pruning, factor):
    """Distances with negative entries and signed zeros (a tenth each of -0.0
    and +0.0): the column minimum over negatives, and a zero threshold of
    either sign, prune as JAX does."""
    rng = np.random.default_rng(17)
    rec = jdtw.DTWRecognizer.from_features(_templates(rng, [6, 9, 5, 11, 8]))
    dist = rng.normal(size=(39, 24)).astype(np.float32)
    u = rng.random(dist.shape)
    dist[u < 0.1] = -0.0
    dist[(u >= 0.1) & (u < 0.2)] = 0.0
    want = np.asarray(jdtw.dtw_multi_template(
        dist, rec._is_first, rec._is_second, rec._end_rows, pruning=pruning,
        pruning_factor=factor))
    got = tdtw.dtw_multi_template(torch.as_tensor(dist), rec._is_first, rec._is_second,
                                  rec._end_rows, pruning=pruning, pruning_factor=factor)
    np.testing.assert_array_equal(got.numpy(), want)
