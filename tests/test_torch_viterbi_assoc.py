"""The port's associative-scan Viterbi (ops/viterbi_assoc.py) against the
JAX package's and against the sequential trellises, on the CPU.

Tolerances: alphas and scores against JAX's associative scan within rtol
1e-6 / atol 1e-5 (the same up-sweep and down-sweep order; measured bitwise
on this CPU), paths equal; against the sequential recursion rtol 1e-4 /
atol 1e-3, as tests/test_viterbi_assoc.py holds JAX's (the adds
re-associate), and paths equal where no two predecessors tie (random
float emissions).
"""
import numpy as np
import pytest
import torch

from cs304_tpu.ops import viterbi_assoc as jassoc
from cs304_tpu_torch.models.hmm import uniform_forward_log_a
from cs304_tpu_torch.ops import viterbi_assoc as tassoc
from cs304_tpu_torch.ops.viterbi import (
    banded_transition_matrix,
    viterbi_banded,
    viterbi_composite,
)
from torch_poison import KERNEL_POISONS, differing_cells, plain_run, poisoned


def _word(rng, s, t):
    log_a = uniform_forward_log_a(s)
    trans = banded_transition_matrix(torch.as_tensor(log_a))
    log_b = (rng.normal(size=(t, s)) * 2).astype(np.float32)
    alpha0 = np.full(s, -np.inf, np.float32)
    alpha0[0] = log_b[0, 0] + log_a[0, 0]
    return log_a, trans, log_b, alpha0


@pytest.mark.parametrize("t", [1, 2, 3, 16, 33, 64])
def test_alphas_match_jax_and_sequential(rng, t):
    log_a, trans, log_b, alpha0 = _word(rng, 6, t)
    got = tassoc.viterbi_alphas_assoc(torch.as_tensor(log_b), trans,
                                      torch.as_tensor(alpha0)).numpy()
    want = np.asarray(jassoc.viterbi_alphas_assoc(log_b, trans.numpy(), alpha0))
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-5)
    seq = np.full((t, 6), -np.inf, np.float64)
    seq[0] = alpha0
    for i in range(1, t):
        for j in range(6):
            seq[i, j] = np.max(seq[i - 1] + trans.numpy()[:, j]) + log_b[i, j]
    assert np.array_equal(np.isfinite(seq), fin)
    np.testing.assert_allclose(got[fin], seq[fin], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("poison", KERNEL_POISONS)
@pytest.mark.parametrize("t", [16, 33])
def test_assoc_scan_on_poisoned_memory_matches_jax(t, poison):
    """_associative_scan's output is a torch.empty_like allocation: on memory
    filled with a poison the alphas (an even and an odd T) stay within the
    JAX tolerance above, and equal those computed on memory filled with
    another pattern in every bit."""
    log_a, trans, log_b, alpha0 = _word(np.random.default_rng(t), 6, t)
    args = (torch.as_tensor(log_b), trans, torch.as_tensor(alpha0))
    with poisoned(poison):
        got = tassoc.viterbi_alphas_assoc(*args)
    want = np.asarray(jassoc.viterbi_alphas_assoc(log_b, trans.numpy(), alpha0))
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got.numpy()), fin)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6, atol=1e-5)
    assert differing_cells(got, plain_run(tassoc.viterbi_alphas_assoc, *args)) == 0


def test_full_viterbi_matches_banded_and_jax(rng):
    log_a, trans, log_b, alpha0 = _word(rng, 5, 41)
    final = np.zeros(5, bool)
    final[-1] = True
    score, path = tassoc.viterbi_assoc(torch.as_tensor(log_b), trans,
                                       torch.as_tensor(alpha0), torch.as_tensor(final))
    want_s, want_p = viterbi_banded(torch.as_tensor(log_b), torch.as_tensor(log_a),
                                    quirk_backtrace=False)
    assert float(score) == pytest.approx(float(want_s), rel=1e-4, abs=1e-3)
    assert torch.equal(path, want_p)
    j_s, j_p = jassoc.viterbi_assoc(log_b, trans.numpy(), alpha0, final)
    assert float(score) == pytest.approx(float(j_s), rel=1e-6, abs=1e-5)
    np.testing.assert_array_equal(path.numpy(), np.asarray(j_p))


@pytest.mark.parametrize("t", [1, 37, 100])
def test_composite_assoc_matches_sequential_and_jax(rng, t):
    state_counts = [5, 3, 4]
    s_total = sum(state_counts)
    log_a = np.full((s_total, s_total), -np.inf, np.float32)
    lowers, uppers, base = [], [], 0
    for n in state_counts:
        log_a[base: base + n, base: base + n] = uniform_forward_log_a(n)
        lowers.append(base)
        uppers.append(base + n - 1)
        base += n
    lower_of = np.zeros(s_total, np.int32)
    for lo in lowers:
        lower_of[lo:] = lo
    entry = np.zeros(s_total, bool)
    entry[lowers] = True
    exit_ = np.zeros(s_total, bool)
    exit_[uppers] = True
    log_b = (rng.normal(size=(t, s_total)) * 2).astype(np.float32)
    topo = (log_a, lower_of, entry, exit_, -7.0)
    score, path = tassoc.viterbi_composite_assoc(torch.as_tensor(log_b), *topo)
    want_s, want_p = viterbi_composite(torch.as_tensor(log_b), *topo,
                                       quirk_backtrace=False)
    assert float(score) == pytest.approx(float(want_s), rel=1e-4, abs=1e-3)
    assert torch.equal(path, want_p)
    j_s, j_p = jassoc.viterbi_composite_assoc(log_b, *topo)
    assert float(score) == pytest.approx(float(j_s), rel=1e-6, abs=1e-5)
    np.testing.assert_array_equal(path.numpy(), np.asarray(j_p))


@pytest.mark.parametrize("t", [1, 2, 29])
def test_assoc_backtrace_ties_match_jax(rng, t):
    """Integer emissions on a uniform upper-triangular word: predecessors
    tie, and the backtrace (first-max table walked by K2-bt's plain
    version) takes the lowest index as JAX's argmax does; scores bitwise."""
    s = 6
    trans = torch.as_tensor(np.where(np.isfinite(uniform_forward_log_a(s)), 0.0,
                                     -np.inf).astype(np.float32))
    log_b = rng.integers(-2, 1, size=(t, s)).astype(np.float32)
    alpha0 = np.zeros(s, np.float32)
    alpha0[3:] = -np.inf
    final = np.zeros(s, bool)
    final[[2, 4, 5]] = True
    score, path = tassoc.viterbi_assoc(torch.as_tensor(log_b), trans,
                                       torch.as_tensor(alpha0), torch.as_tensor(final))
    j_s, j_p = jassoc.viterbi_assoc(log_b, trans.numpy(), alpha0, final)
    assert float(score) == float(j_s)
    assert path.dtype == torch.int32 and path.shape == (t,)
    np.testing.assert_array_equal(path.numpy(), np.asarray(j_p))
