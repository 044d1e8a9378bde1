"""The dense trellis kernel's reductions, emulated in numpy, against
ops/viterbi.dense_forward (alpha with its signs of zero, and every
backpointer) and JAX's interpret-mode viterbi_forward_pallas, on integer
ties, all -inf columns and signed zeros. Both reductions find the first
max and keep that row's own value:

- "chains" (trans streamed from L2): four chains (i mod 4), each a first max
  on a strict >, merged by a lexicographic max of (value, -index);
- "groups" (trans resident in shared memory): groups of four rows; the
  running max takes a group only when its max is strictly greater, then the
  first row of that group attaining it; its value recomputed; with "2 row
  warps" the rows split in two halves merged as the chains are.

Once t >= length the first frozen backpointer row is copied to the rest.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.ops.pallas.trellis import viterbi_forward_pallas
from cs304_tpu_torch.ops import viterbi as tv

CHAINS = 4


def _better(v, i, bv, bi):
    return (v > bv) | ((v == bv) & (i < bi))


def _chains(cand, s):
    """cand (B, S4, S) -> first-max value and index over the rows."""
    b = cand.shape[0]
    best = np.full((b, CHAINS, s), -np.inf, np.float32)
    arg = np.broadcast_to(np.arange(CHAINS)[None, :, None], (b, CHAINS, s)).copy()
    for i in range(cand.shape[1]):
        c = i % CHAINS
        take = cand[:, i] > best[:, c]
        best[:, c] = np.where(take, cand[:, i], best[:, c])
        arg[:, c] = np.where(take, i, arg[:, c])
    m, mi = best[:, 0], arg[:, 0]
    for c in range(1, CHAINS):
        win = _better(best[:, c], arg[:, c], m, mi)
        m, mi = np.where(win, best[:, c], m), np.where(win, arg[:, c], mi)
    return m, mi


def _groups(cand, s, row_warps):
    """cand (B, S4, S) -> first-max value and index, by groups of four rows
    in each of row_warps row ranges, merged in order."""
    b, s4 = cand.shape[:2]
    rs = -(-s4 // row_warps)
    rs = -(-rs // CHAINS) * CHAINS  # rows a row warp, a multiple of four
    cols = np.arange(s)[None, :]
    rows_b = np.arange(b)[:, None]
    out = None
    for w in range(row_warps):
        lo, hi = w * rs, min((w + 1) * rs, s4)
        gv = np.full((b, s), -np.inf, np.float32)
        gg = np.full((b, s), lo)
        for g in range(lo, hi, CHAINS):
            m4 = cand[:, g:g + CHAINS].max(axis=1)
            take = m4 > gv
            gv, gg = np.where(take, m4, gv), np.where(take, g, gg)
        idx = gg.copy()
        if hi > lo:
            for r in range(CHAINS - 1, -1, -1):
                v = cand[rows_b, gg + r, cols]
                idx = np.where(v == gv, gg + r, idx)
        val = np.where(hi > lo, cand[rows_b, np.minimum(idx, s4 - 1), cols], -np.inf)
        if out is None:
            out = (val, idx)
        else:
            win = _better(val, idx, *out)
            out = (np.where(win, val, out[0]), np.where(win, idx, out[1]))
    return out


def kernel_forward(log_b, trans, alpha0, lengths, reduction="chains", row_warps=1):
    """The kernel's reduction order on (B, T, S) float32 numpy inputs ->
    (alpha (B, S), bp (B, T, S) int32)."""
    b, t_total, s = log_b.shape
    s4 = -(-s // CHAINS) * CHAINS
    trans4 = np.full((s4, s), -np.inf, np.float32)
    trans4[:s] = trans
    alpha = alpha0.copy()
    bp = np.empty((b, t_total, s), np.int32)
    bp[:, 0] = -1
    live_end = np.minimum(np.maximum(lengths, 1), t_total)
    for t in range(1, t_total):
        alpha4 = np.full((b, s4), -np.inf, np.float32)
        alpha4[:, :s] = alpha
        cand = alpha4[:, :, None] + trans4[None]
        if reduction == "chains":
            m, mi = _chains(cand, s)
        else:
            m, mi = _groups(cand, s, row_warps)
        # Rows after the first frozen one repeat it.
        frozen = (t > live_end)[:, None]
        bp[:, t] = np.where(frozen, bp[:, t - 1], mi)
        live = (t < lengths)[:, None]
        alpha = np.where(live, (m + log_b[:, t]).astype(np.float32), alpha)
    return alpha, bp


def _case(name, rng):
    b, t, s = {"ties": (6, 20, 13), "neg-inf": (5, 12, 9), "zeros": (4, 10, 7),
               "tiny": (3, 6, 2), "wide": (3, 8, 37)}[name]
    if name == "zeros":
        # Every value a zero of random sign: the max ties everywhere, and the
        # winner's sign of zero must reach alpha.
        sign = lambda *sh: np.where(rng.random(sh) < 0.5, -1.0, 1.0).astype(np.float32)  # noqa: E731
        trans = 0.0 * sign(s, s)
        trans[rng.random((s, s)) < 0.2] = -np.inf
        alpha0 = 0.0 * sign(b, s)
        log_b = 0.0 * sign(b, t, s)
    else:
        trans = rng.integers(-2, 1, size=(s, s)).astype(np.float32)
        trans[rng.random((s, s)) < 0.3] = -np.inf
        alpha0 = rng.integers(-3, 1, size=(b, s)).astype(np.float32)
        alpha0[rng.random((b, s)) < 0.3] = -np.inf
        log_b = rng.integers(-3, 1, size=(b, t, s)).astype(np.float32)
    if name == "neg-inf":
        trans[:, ::3] = -np.inf  # all -inf columns point at 0
        alpha0[0] = -np.inf      # an utterance with nothing reachable
    lengths = rng.integers(0, t + 2, size=b).astype(np.int32)
    lengths[0] = t
    return log_b, trans, alpha0, lengths


REDUCTIONS = {"chains": ("chains", 1), "groups": ("groups", 1),
              "groups-2-row-warps": ("groups", 2)}


@pytest.mark.parametrize("reduction", sorted(REDUCTIONS))
@pytest.mark.parametrize("name", ["ties", "neg-inf", "zeros", "tiny", "wide"])
def test_split_reduction_is_bitwise_dense_forward_and_jax(name, reduction):
    log_b, trans, alpha0, lengths = _case(name, np.random.default_rng(len(name)))
    kind, row_warps = REDUCTIONS[reduction]
    got_a, got_bp = kernel_forward(log_b, trans, alpha0, lengths, kind, row_warps)
    want_a, want_bp = tv.dense_forward(*(torch.as_tensor(x) for x in
                                         (log_b, trans, alpha0, lengths)))
    np.testing.assert_array_equal(got_bp, want_bp.numpy())
    np.testing.assert_array_equal(got_a, want_a.numpy())
    np.testing.assert_array_equal(np.signbit(got_a), np.signbit(want_a.numpy()))
    ja, jbp = viterbi_forward_pallas(*(jnp.asarray(x) for x in
                                       (log_b, trans, alpha0, lengths)), interpret=True)
    np.testing.assert_array_equal(got_bp, np.asarray(jbp))
    np.testing.assert_array_equal(got_a, np.asarray(ja))
