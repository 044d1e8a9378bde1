"""The port's single-word banded Viterbi (ops/viterbi.viterbi_banded_batch,
the segmental k-means E-step) against cs304_tpu.ops.viterbi.

Tolerance: scores bitwise equal; paths equal within each utterance's length.
Cases: random log_a rows with -inf gaps, integer-valued emissions for exact
ties, a zero-probability entry self-loop (the degenerate-safe init), length-0
rows and T = 1.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.ops import viterbi as jv
from cs304_tpu_torch.models.hmm import uniform_forward_log_a
from cs304_tpu_torch.ops import viterbi as tv


def _log_a(rng, s, degenerate=False):
    a = rng.random((s, s)).astype(np.float32) * np.triu(np.ones((s, s), np.float32))
    a[rng.random((s, s)) < 0.2] = 0.0
    a[:, -1] += 1e-3  # every row keeps some mass
    with np.errstate(divide="ignore"):
        log_a = np.log(a / a.sum(1, keepdims=True)).astype(np.float32)
    if degenerate:
        log_a[0, 0] = -np.inf
    return log_a


@pytest.mark.parametrize("case", ["random", "ties", "degenerate", "zero-length", "T1"])
def test_viterbi_banded_batch_matches_jax(case):
    rng = np.random.default_rng(len(case))
    b, t, s = 7, 1 if case == "T1" else 15, 5
    log_b = rng.normal(size=(b, t, s)).astype(np.float32) * 3
    if case == "ties":
        log_b = np.round(log_b)
    log_a = (uniform_forward_log_a(s) if case == "ties"
             else _log_a(rng, s, degenerate=case == "degenerate"))
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    if case == "zero-length":
        lengths[2::3] = 0
    want_s, want_p = jv.viterbi_banded_batch(
        jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lengths))
    got_s, got_p = tv.viterbi_banded_batch(
        torch.from_numpy(log_b), torch.from_numpy(log_a), torch.from_numpy(lengths))
    np.testing.assert_array_equal(np.asarray(want_s), got_s.numpy())
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(np.asarray(want_p)[i, :n], got_p.numpy()[i, :n])


def test_single_utterance_and_band_mask():
    rng = np.random.default_rng(3)
    log_b = rng.normal(size=(9, 4)).astype(np.float32)
    log_a = rng.normal(size=(4, 4)).astype(np.float32)
    want = jv.viterbi_banded(jnp.asarray(log_b), jnp.asarray(log_a), 7)
    got = tv.viterbi_banded(torch.from_numpy(log_b), torch.from_numpy(log_a), 7)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1])[:7], got[1].numpy()[:7])
    np.testing.assert_array_equal(
        np.asarray(jv.banded_transition_matrix(jnp.asarray(log_a))),
        tv.banded_transition_matrix(torch.from_numpy(log_a)).numpy())
