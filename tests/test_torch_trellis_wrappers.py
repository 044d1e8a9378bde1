"""The port's K5 and K6 (ops/cuda/trellis_fast.py, ops/cuda/trellis_lanes.py:
wrappers of the JAX signatures over the scan-free forward, whose plain
version CPU tensors run) against the JAX package's batch-in-lanes and
states-in-lanes Pallas kernels in interpret mode, as tests/test_pallas_fast.py
and tests/test_pallas_lanes.py compare those with the fast scan: alpha and
every backpointer BITWISE equal, then scores and live paths through the
JAX backtrace.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.models.hmm import uniform_forward_log_a
from cs304_tpu.ops.pallas.trellis_fast import viterbi_fast_forward_pallas as j_fast
from cs304_tpu.ops.pallas.trellis_lanes import viterbi_lanes_forward_pallas as j_lanes
from cs304_tpu.ops.viterbi import _backtrace, viterbi_composite_batch_fast
from cs304_tpu_torch.ops.cuda import trellis_fast as tfast
from cs304_tpu_torch.ops.cuda import trellis_lanes as tlanes
from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf

KERNELS = {"fast": (j_fast, tfast.viterbi_fast_forward_pallas, tfast.S_PAD),
           "lanes": (j_lanes, tlanes.viterbi_lanes_forward_pallas, tlanes.S_LANES)}


def _topology(state_counts):
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
    return log_a, lower_of, entry, exit_


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("case", ["small", "flagship-size", "integer-ties"])
def test_wrapper_matches_pallas_interpret(kernel, case):
    jfn, tfn, _limit = KERNELS[kernel]
    counts = [5, 3, 4] if case == "small" else [5] * 11 + [3]
    topo = _topology(counts)
    rng = np.random.default_rng(len(counts))
    b, t = (5, 26) if case == "small" else (9, 40)
    s = sum(counts)
    if case == "integer-ties":
        log_b = rng.integers(-3, 1, size=(b, t, s)).astype(np.float32)
    else:
        log_b = (rng.normal(size=(b, t, s)) * 2).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, size=b).astype(np.int32)
    penalty = -4.0
    j_alpha, j_bp = jfn(jnp.asarray(log_b), *(jnp.asarray(a) for a in topo), penalty,
                        jnp.asarray(lengths), t_blk=8, interpret=True)
    before = tsf.trellis_forward.launches
    alpha, bp = tfn(torch.as_tensor(log_b), *topo, penalty, torch.as_tensor(lengths),
                    t_blk=8)
    assert tsf.trellis_forward.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(j_alpha))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(j_bp))

    want_scores, want_paths = viterbi_composite_batch_fast(
        jnp.asarray(log_b), *(jnp.asarray(a) for a in topo), penalty,
        jnp.asarray(lengths))
    exit_scores = np.where(topo[3][None, :], alpha.numpy(), -np.inf)
    np.testing.assert_array_equal(exit_scores.max(axis=1), np.asarray(want_scores))
    best = exit_scores.argmax(axis=1).astype(np.int32)
    paths = jax.vmap(lambda b_, s_, l: _backtrace(b_, s_, l, True))(
        jnp.asarray(bp.numpy()), jnp.asarray(best), jnp.asarray(lengths))
    np.testing.assert_array_equal(np.asarray(paths), np.asarray(want_paths))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_wrapper_rejects_more_states_than_the_tpu_kernel(kernel):
    _jfn, tfn, limit = KERNELS[kernel]
    topo = _topology([limit + 1])
    log_b = torch.zeros((2, 4, limit + 1))
    with pytest.raises(ValueError, match=f"<= {limit}"):
        tfn(log_b, *topo, -4.0, torch.full((2,), 4, dtype=torch.int32))
    # At the limit it runs.
    topo = _topology([limit])
    alpha, bp = tfn(log_b[..., :limit], *topo, -4.0, torch.full((2,), 4, dtype=torch.int32))
    assert alpha.shape == (2, limit) and bp.shape == (2, 4, limit)
