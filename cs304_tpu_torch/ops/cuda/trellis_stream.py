"""The serving pool's step on the card: the stream mode of the scan-free
team kernel (csrc/trellis_scanfree.cu, MODE STREAM), and the dense step
through K4 (csrc/trellis_dense.cu).

The JAX package runs the pool's step as a ``lax.scan`` of the composite
max-plus recursion (cs304_tpu/ops/streaming_batch.py:52 ``_advance``, :130
``_advance_banded``, :201 ``_advance_compact``); there is no Pallas kernel
of it. Written as plain PyTorch it is a Python loop of ~15 launches a frame.

- stream_advance is ONE launch for a pool step of R rows (the compact
  upload's fed slots, or every slot for the dense upload, idle ones with
  valid 0): each row's alpha is read from and written back to the pool's
  (B, S) carry in place, its backpointers go into the (B, T_max, S) ring at
  their absolute frames (int8 or int32, the pool's ring_dtype). It is
  bitwise its plain version, ops/streaming_batch.py:_advance_compact with
  the banded coefficients (pack_coefs rows), which a CPU tensor runs.
- stream_advance_lm is the same step with a bigram LM's per-word entry
  update (the LM variant of the stream mode), one launch; it replaces the
  JAX pool's banded step with lm (cs304_tpu/ops/streaming_batch.py:97
  _banded_coeffs, :201), and its plain version is _advance_compact with
  _coeffs_of(coefs, penalty, lm).
- dense_stream_advance is the dense step (the JAX package's choice at
  <= 127 states) on K4, whose row 0 is its seed row: a continuing row gets
  its carried alpha as alpha0 and its chunk at rows 1..C (length valid + 1),
  a fresh row (clock 0) the seed of its frame 0 as alpha0 and its frames
  1..C-1 at rows 1..C-1 (length valid); one gather builds that layout, one
  scatter puts alpha and the live frames' backpointers back. It is bitwise
  ops/streaming_batch.py:_advance (K4 is bitwise dense_forward, whose
  argmax is the first max as jnp.argmax's).

What bounds the stream mode: like the decode mode, a chain of dependent
steps per row (latency); bytes are the rows' emissions read once and their
backpointers written once. A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import upload_ints
from ..viterbi import NEG
from . import _build
from .trellis_dense import trellis_dense_forward
from .trellis_scanfree import MAX_STATES, _check_cuda, _check_lm

__all__ = ["dense_stream_advance", "k4_chunk", "stream_advance", "stream_advance_lm"]


def _plain_step(alpha, ring, slot_ids, t, valid, log_b, coefs, penalty, lm=None):
    from ..streaming_batch import _advance_compact, _coeffs_of

    return _advance_compact(alpha, ring, slot_ids, t, valid, log_b, coefs[6],
                            coefs[4] > 0, coeffs=_coeffs_of(coefs, penalty, lm))


def stream_advance(alpha, ring, slot_ids, t, valid, log_b, coefs, penalty):
    """One pool step, in place: alpha (B, S) float32 and ring (B, T_max, S)
    int8 or int32 are updated and returned; slot_ids, t, valid (R,) int32
    (a row with valid 0 is skipped; rows name distinct slots); log_b
    (R, C, ld >= S) float32; coefs (8, S) from pack_coefs; penalty float."""
    if not alpha.is_cuda:
        return _plain_step(alpha, ring, slot_ids, t, valid, log_b, coefs, penalty)
    b, t_max, s, r, c, ld = _check_step(alpha, ring, slot_ids, t, valid, log_b, coefs)
    lib = _build.load()
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_stream(
            alpha.data_ptr(), ring.data_ptr(), ring.element_size(),
            slot_ids.data_ptr(), t.data_ptr(), valid.data_ptr(), log_b.data_ptr(),
            coefs.data_ptr(), float(penalty), r, c, s, ld, b, t_max, stream,
        )
    _build.check(code, "stream_advance")
    stream_advance.launches += 1
    return alpha, ring


stream_advance.launches = 0


def stream_advance_lm(alpha, ring, slot_ids, t, valid, log_b, coefs, lm):
    """stream_advance with a bigram LM's entry update: lm =
    ops/viterbi.lm_tables' (pair (W, W) float32, word_of_state (S,) int32,
    uppers (W,) int32) on the pool's device; the ring keeps full source
    states. One launch on CUDA tensors."""
    if not alpha.is_cuda:
        return _plain_step(alpha, ring, slot_ids, t, valid, log_b, coefs, 0.0, lm)
    b, t_max, s, r, c, ld = _check_step(alpha, ring, slot_ids, t, valid, log_b, coefs)
    w = _check_lm(lm, s)
    pair, word_of, uppers = lm
    if pair.device != alpha.device:
        raise ValueError("the LM tables and the pool are on different devices")
    lib = _build.load()
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_stream_lm(
            alpha.data_ptr(), ring.data_ptr(), ring.element_size(),
            slot_ids.data_ptr(), t.data_ptr(), valid.data_ptr(), log_b.data_ptr(),
            coefs.data_ptr(), pair.data_ptr(), word_of.data_ptr(), uppers.data_ptr(), w,
            r, c, s, ld, b, t_max, stream,
        )
    _build.check(code, "stream_advance_lm")
    stream_advance_lm.launches += 1
    return alpha, ring


stream_advance_lm.launches = 0


def _check_step(alpha, ring, slot_ids, t, valid, log_b, coefs):
    """Validate a pool step's CUDA inputs -> (B, T_max, S, R, C, ld)."""
    b, t_max, s = ring.shape
    r, c, ld = log_b.shape
    _check_cuda("alpha", alpha, torch.float32)
    if ring.dtype not in (torch.int8, torch.int32) or not ring.is_cuda or not ring.is_contiguous():
        raise TypeError(f"ring must be a contiguous CUDA int8/int32 tensor, got {ring.dtype}")
    for name, x in (("slot_ids", slot_ids), ("t", t), ("valid", valid)):
        _check_cuda(name, x, torch.int32)
        if x.shape != (r,):
            raise ValueError(f"{name} {tuple(x.shape)} vs {r} rows")
    _check_cuda("log_b", log_b, torch.float32)
    _check_cuda("coefs", coefs, torch.float32)
    if alpha.shape != (b, s) or coefs.shape != (8, s) or not 1 <= s <= min(ld, MAX_STATES):
        raise ValueError(
            f"alpha {tuple(alpha.shape)}, ring {tuple(ring.shape)}, coefs "
            f"{tuple(coefs.shape)}, log_b {tuple(log_b.shape)}: need (B, S), "
            f"(B, T_max, S), (8, S) and ld >= S, 1 <= S <= {MAX_STATES}")
    if r < 1 or c < 1:
        raise ValueError(f"log_b {tuple(log_b.shape)}: need at least one row and frame")
    devs = {x.device for x in (alpha, ring, slot_ids, t, valid, log_b, coefs)}
    if len(devs) != 1:
        raise ValueError(f"stream_advance inputs on different devices: {devs}")
    return b, t_max, s, r, c, ld


def k4_chunk(alpha_rows, t, valid, log_b, trans, coefs):
    """One chunk per row through K4 (its plain version on the CPU):
    alpha_rows (R, S) carried alphas, host t/valid (R,) clocks and frame
    counts, log_b (R, C, >=S) -> (alpha (R, S), bp (R, C, S) int32 where
    bp[r, k] is frame k's backpointer row, -1 at an absolute frame 0). A row
    with valid 0 keeps its alpha."""
    r, c = log_b.shape[:2]
    s = trans.shape[0]
    t = np.asarray(t)
    valid = np.asarray(valid)
    off = np.where(t == 0, 0, 1)  # K4 row j holds chunk frame j - off
    frame_of, row_of, fresh, lengths = upload_ints((
        np.clip(np.arange(c + 1)[None, :] - off[:, None], 0, c - 1),
        np.arange(c)[None, :] + off[:, None],  # frame k at K4 row k + off
        (t == 0) & (valid > 0),
        np.where(valid > 0, valid + off, 0),
    ), log_b.device)
    lb = log_b[..., :s].gather(1, frame_of[..., None].expand(r, c + 1, s))
    seed = torch.where(coefs[4] > 0, log_b[:, 0, :s] + coefs[6], NEG)
    alpha0 = torch.where(fresh[:, None] != 0, seed, alpha_rows).contiguous()
    alpha, bp = trellis_dense_forward(lb, trans, alpha0, lengths.to(torch.int32))
    return alpha, bp.gather(1, row_of[..., None].expand(r, c, s))


def dense_stream_advance(alpha, ring, slot_ids, t, valid, log_b, trans, coefs):
    """The dense pool step, in place: alpha (B, S), ring (B, T_max, S);
    host slot_ids/t/valid (R,) (padding rows carry slot B and valid 0);
    log_b (R, C, >=S); trans (S, S) from composite_transition_matrix.
    Returns (alpha, ring)."""
    b, t_max, s = ring.shape
    c = log_b.shape[1]
    dev = alpha.device
    slot_ids, t, valid = (np.asarray(x, np.int64) for x in (slot_ids, t, valid))
    live = (valid > 0) & (slot_ids < b)
    rows = np.nonzero(live)[0]
    if not len(rows):
        return alpha, ring
    # Frame k < valid of live row r -> ring row (slot, t + k).
    rr = np.repeat(rows, valid[rows])
    kk = np.arange(len(rr)) - np.repeat(np.cumsum(valid[rows]) - valid[rows], valid[rows])
    safe, slots, rows_d, src, dst = upload_ints((
        np.where(slot_ids < b, slot_ids, 0), slot_ids[rows], rows, rr * c + kk,
        slot_ids[rr] * t_max + np.minimum(t[rr] + kk, t_max - 1),
    ), dev)
    new_alpha, bp = k4_chunk(alpha.index_select(0, safe), t, np.where(live, valid, 0),
                             log_b, trans, coefs)
    alpha.index_copy_(0, slots, new_alpha.index_select(0, rows_d))
    ring.view(b * t_max, s).index_copy_(
        0, dst, bp.reshape(-1, s).index_select(0, src).to(ring.dtype))
    return alpha, ring
