"""The port's dense composite trellis (cs304_tpu_torch.ops.viterbi:
composite_transition_matrix, dense_forward, viterbi_composite(_batch), and
ops/cuda/trellis_dense.py on CPU tensors) against the JAX package's
viterbi_composite_batch (the "scan" backend), its dense Pallas forward
viterbi_forward_pallas and viterbi_composite_batch_pallas (interpret mode).

Max-plus uses only float32 adds and compares, so transition matrices,
alphas, backpointers, scores and full padded paths must be BITWISE equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.ops import viterbi as jv
from cs304_tpu.ops.pallas.trellis import viterbi_forward_pallas
from cs304_tpu_torch.ops import viterbi as tv
from cs304_tpu_torch.ops.cuda import trellis_dense as tdn
from test_torch_viterbi import _composite, _topology
from test_torch_viterbi_ties import _tie_topology
from torch_poison import KERNEL_POISONS, poisoned

j_scan = jax.jit(jv.viterbi_composite_batch, static_argnames=("quirk_backtrace",))
j_pallas = jax.jit(jv.viterbi_composite_batch_pallas,
                   static_argnames=("quirk_backtrace", "interpret"))


def _jargs(topo, lengths):
    log_a, lower, entry, exit_, pen = topo
    return (jnp.asarray(log_a), jnp.asarray(lower), jnp.asarray(entry),
            jnp.asarray(exit_), jnp.float32(pen), jnp.asarray(lengths))


def _targs(topo, lengths):
    log_a, lower, entry, exit_, pen = topo
    return (log_a, lower, entry, exit_, float(pen), torch.as_tensor(lengths))


def _assert_dense_bitwise(log_b, lengths, topo, quirk=True, with_pallas=True):
    """Port scan + pallas backends (CPU) == JAX scan (+ pallas interpret)."""
    jargs = _jargs(topo, lengths)
    refs = [j_scan(jnp.asarray(log_b), *jargs, quirk_backtrace=quirk)]
    if with_pallas:
        refs.append(j_pallas(jnp.asarray(log_b), *jargs, quirk_backtrace=quirk,
                             interpret=True))
    targs = _targs(topo, lengths)
    gots = [tv.viterbi_composite_batch(torch.as_tensor(log_b), *targs,
                                       quirk_backtrace=quirk),
            tdn.viterbi_composite_batch_pallas(torch.as_tensor(log_b), *targs,
                                               quirk_backtrace=quirk)]
    for rs, rp in refs:
        for gs, gp in gots:
            assert gp.dtype == torch.int32
            np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
            np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
    return gots[0]


def _single_state_composite():
    """Words of 1, 5, 1 and 3 states: a single-state word is both entry and
    exit, so its column takes max(penalty, self-loop)."""
    return _composite(4, [1, 5, 1, 3], seed=2)


@pytest.mark.parametrize("which", ["random", "single-state"])
def test_composite_transition_matrix_matches_jax(which):
    comp = _composite(5, [5, 3, 4]) if which == "random" else _single_state_composite()
    log_a, lower, entry, exit_, pen = _topology(comp)
    want = jv.composite_transition_matrix(jnp.asarray(log_a), jnp.asarray(lower),
                                          jnp.asarray(entry), jnp.asarray(exit_), pen)
    got = tv.composite_transition_matrix(log_a, lower, entry, exit_, float(pen))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["random", "short-lengths", "integer-ties",
                                  "single-state", "no-quirk"])
def test_viterbi_composite_batch_matches_jax(case):
    comp = _single_state_composite() if case == "single-state" else _composite(5, [5, 3, 4])
    rng = np.random.default_rng(3)
    b, t, s = 6, 25, comp.num_states
    if case == "integer-ties":
        log_b = rng.integers(-3, 1, size=(b, t, s)).astype(np.float32)
    else:
        log_b = (rng.normal(size=(b, t, s)) * 3).astype(np.float32)
    lo = 1 if case == "short-lengths" else t // 2
    lengths = rng.integers(lo, t + 1, size=b).astype(np.int32)
    if case == "short-lengths":
        lengths[:3] = [1, 2, 3]
    _assert_dense_bitwise(log_b, lengths, _topology(comp), quirk=case != "no-quirk")


def test_entry_self_loop_beats_higher_exit_on_exact_tie():
    """tests/test_tie_break.py's first case: at t=2 entry 2 ties exactly
    between its self-loop and exit 3 + penalty. The dense trellis takes the
    self-loop (lowest predecessor index); the banded one takes the exit."""
    s = 4
    log_a = np.full((s, s), -np.inf, np.float32)
    log_a[0, 0], log_a[0, 1], log_a[1, 1] = -1.0, -1.0, -1.0
    log_a[2, 2], log_a[2, 3], log_a[3, 3] = -1.0, -2.0, 0.0
    log_b = np.zeros((1, 3, s), np.float32)
    log_b[0, 0, 0] = -10.0
    log_b[0, 1, 2] = -4.0
    topo = _tie_topology([0, 2], [1, 3], log_a, -4.0)
    lengths = np.array([3], np.int32)
    _assert_dense_bitwise(log_b, lengths, topo)
    log_a, lower, entry, exit_, pen = topo
    coefs = tv.pack_coefs(log_a, lower, entry, exit_)
    trans = tv.composite_transition_matrix(*topo)
    lb = torch.as_tensor(log_b)
    alpha0 = torch.where(coefs[4] > 0, lb[:, 0] + coefs[6], tv.NEG)
    _a, dense_bp = tv.dense_forward(lb, trans, alpha0, torch.as_tensor(lengths))
    _a, fast_bp = tv.forward_fast(lb, coefs, float(pen), torch.as_tensor(lengths))
    assert dense_bp[0, 2, 2] == 2 and fast_bp[0, 2, 2] == 3


def test_viterbi_composite_single_utterance_matches_jax():
    comp = _composite(3, [5, 3])
    topo = _topology(comp)
    rng = np.random.default_rng(4)
    log_b = (rng.normal(size=(30, comp.num_states)) * 3).astype(np.float32)
    for length in (None, 17):
        ws, wp = jv.viterbi_composite(jnp.asarray(log_b), *_jargs(topo, 0)[:5],
                                      length=length)
        gs, gp = tv.viterbi_composite(torch.as_tensor(log_b), *_targs(topo, [0])[:5],
                                      length=length)
        assert float(gs) == float(ws)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("b,t,s", [(5, 30, 13), (9, 12, 130), (3, 1, 7)])
def test_dense_forward_matches_pallas_interpret(b, t, s):
    """dense_forward (K4's plain version) == viterbi_forward_pallas in
    interpret mode, alpha and every backpointer, with -inf sprinkled into
    trans and alpha0 and lengths below T."""
    _dense_forward_vs_pallas(b, t, s)


@pytest.mark.parametrize("poison", KERNEL_POISONS)
def test_dense_forward_on_poisoned_memory_matches_pallas_interpret(poison):
    """dense_forward's backpointers are a torch.empty allocation: on memory
    filled with a poison every backpointer, past each row's length too,
    stays viterbi_forward_pallas's."""
    with poisoned(poison):
        _dense_forward_vs_pallas(7, 25, 13)


def _dense_forward_vs_pallas(b, t, s):
    rng = np.random.default_rng(s)
    trans = rng.normal(size=(s, s)).astype(np.float32)
    trans[rng.random((s, s)) < 0.4] = -np.inf
    trans[:, 0] = -np.inf  # an all -inf column points at 0
    alpha0 = (rng.normal(size=(b, s)) * 2).astype(np.float32)
    alpha0[rng.random((b, s)) < 0.3] = -np.inf
    log_b = rng.integers(-4, 1, size=(b, t, s)).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    wa, wbp = viterbi_forward_pallas(jnp.asarray(log_b), jnp.asarray(trans),
                                     jnp.asarray(alpha0), jnp.asarray(lengths),
                                     interpret=True)
    before = tdn.trellis_dense_forward.launches
    ga, gbp = tdn.trellis_dense_forward(torch.as_tensor(log_b), torch.as_tensor(trans),
                                        torch.as_tensor(alpha0), torch.as_tensor(lengths))
    assert tdn.trellis_dense_forward.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gbp.numpy(), np.asarray(wbp))


def test_dense_decode_reads_padded_state_columns_in_place():
    """log_b in the emission kernel's layout (128 columns, zeros past S)
    decodes exactly as the unpadded emissions."""
    comp = _composite(4, [5, 3])
    topo = _topology(comp)
    s = comp.num_states
    rng = np.random.default_rng(5)
    log_b = (rng.normal(size=(4, 20, s)) * 3).astype(np.float32)
    padded = np.zeros((4, 20, 128), np.float32)
    padded[..., :s] = log_b
    lengths = torch.as_tensor(rng.integers(5, 21, size=4).astype(np.int32))
    trans = tv.composite_transition_matrix(*topo)
    coefs = tv.pack_coefs(*topo[:4])
    want = tv.dense_decode(torch.as_tensor(log_b), trans, coefs, lengths)
    got = tdn.dense_decode_pallas(torch.as_tensor(padded), trans, coefs, lengths)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
