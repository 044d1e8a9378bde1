"""Scan-free composite Viterbi: wrappers of the CUDA forward and backtrace
kernels (csrc/trellis_scanfree.cu).

Replaces cs304_tpu/ops/pallas/trellis_scanfree.py (_forward_kernel,
_backtrace_kernel). The kernels are bitwise the plain version,
ops/viterbi.py:viterbi_composite_batch_fast (forward_fast + backtrace_batch).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The CUDA pair takes every B >= 1, T >= 1 and
S <= MAX_STATES, with no shape fallback; past MAX_STATES it raises.
The time loop runs inside one block per utterance, so no padding of states
or time is needed; log_b may carry padded state columns (the emission
kernel's layout), which are skipped through its row stride.
"""
from __future__ import annotations

import torch

from ..viterbi import backtrace_batch, first_max, forward_fast, pack_coefs
from . import _build

# Two float32 alpha buffers per block must fit the card's 227 KB of shared
# memory; 8192 states (64 KB) keeps the JAX kernels' limit.
MAX_STATES = 8192

__all__ = [
    "MAX_STATES", "pack_coefs", "trellis_backtrace", "trellis_forward",
    "viterbi_composite_batch_scanfree",
]


def _check_cuda(name, t, dtype):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def trellis_forward(log_b, coefs, penalty, lengths):
    """log_b (B, T, ld >= S) float32, coefs (8, S) float32, penalty float,
    lengths (B,) int32 -> (alpha (B, S) float32, bp (B, T, S) int32)."""
    if not log_b.is_cuda:
        return forward_fast(log_b, coefs, penalty, lengths)
    b, t_total, ld = log_b.shape
    s = coefs.shape[1]
    _check_cuda("log_b", log_b, torch.float32)
    _check_cuda("coefs", coefs, torch.float32)
    _check_cuda("lengths", lengths, torch.int32)
    if coefs.shape[0] != 8 or not 1 <= s <= min(ld, MAX_STATES):
        raise ValueError(
            f"coefs {tuple(coefs.shape)} vs log_b {tuple(log_b.shape)}: need "
            f"(8, S) with 1 <= S <= min(log_b.shape[2], {MAX_STATES})"
        )
    if lengths.shape != (b,) or b < 1 or t_total < 1:
        raise ValueError(f"lengths {tuple(lengths.shape)} vs batch {b}, T {t_total}")
    if not (log_b.device == coefs.device == lengths.device):
        raise ValueError("log_b, coefs and lengths are on different devices")
    lib = _build.load()
    alpha = torch.empty((b, s), dtype=torch.float32, device=log_b.device)
    bp = torch.empty((b, t_total, s), dtype=torch.int32, device=log_b.device)
    with torch.cuda.device(log_b.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_forward(
            log_b.data_ptr(), coefs.data_ptr(), float(penalty),
            lengths.data_ptr(), alpha.data_ptr(), bp.data_ptr(),
            b, t_total, s, ld, stream,
        )
    _build.check(code, "trellis_forward")
    trellis_forward.launches += 1
    return alpha, bp


trellis_forward.launches = 0


def trellis_backtrace(bp, best, lengths, quirk: bool = True):
    """bp (B, T, S) int32, best (B,) int32 start states, lengths (B,) int32
    -> paths (B, T) int32, the reference quirk applied when ``quirk``.
    The kernel follows bp from best without bounds checks: best must lie in
    [0, S) and bp must come from trellis_forward."""
    if not bp.is_cuda:
        return backtrace_batch(bp, best, lengths, quirk)
    b, t_total, s = bp.shape
    _check_cuda("bp", bp, torch.int32)
    _check_cuda("best", best, torch.int32)
    _check_cuda("lengths", lengths, torch.int32)
    if best.shape != (b,) or lengths.shape != (b,):
        raise ValueError(
            f"best {tuple(best.shape)} / lengths {tuple(lengths.shape)} vs batch {b}"
        )
    if not (bp.device == best.device == lengths.device):
        raise ValueError("bp, best and lengths are on different devices")
    lib = _build.load()
    path = torch.empty((b, t_total), dtype=torch.int32, device=bp.device)
    with torch.cuda.device(bp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_backtrace(
            bp.data_ptr(), best.data_ptr(), lengths.data_ptr(),
            path.data_ptr(), b, t_total, s, int(quirk), stream,
        )
    _build.check(code, "trellis_backtrace")
    trellis_backtrace.launches += 1
    return path


trellis_backtrace.launches = 0


def scanfree_decode(log_b, coefs, penalty, lengths, quirk_backtrace: bool = True):
    """Forward + best exit + backtrace on packed coefficients. log_b may
    have padded state columns past S = coefs.shape[1]."""
    alpha, bp = trellis_forward(log_b, coefs, penalty, lengths)
    scores, best = first_max(alpha, coefs[5] > 0)
    return scores, trellis_backtrace(bp, best, lengths, quirk_backtrace)


def viterbi_composite_batch_scanfree(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool = True,
):
    """Drop-in for viterbi_composite_batch_fast: log_b (B, T, S) float32,
    lengths (B,) -> (scores (B,), paths (B, T) int32)."""
    dev = log_b.device
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return scanfree_decode(log_b.contiguous(), coefs, penalty, lengths,
                           quirk_backtrace)
