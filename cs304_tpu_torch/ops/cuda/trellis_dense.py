"""Dense composite Viterbi (the decoder's "pallas" backend): wrapper of the
CUDA forward kernel (csrc/trellis_dense.cu), decoded with K2's backtrace
kernel. The kernel shares trans between the utterances of a block (S up to
~240), of a thread block cluster (S up to 512), or streams each CTA's slice
of it from L2 (past 512); trellis_dense_branch(S) says which.

Replaces cs304_tpu/ops/pallas/trellis.py (_forward_kernel,
viterbi_forward_pallas) and cs304_tpu/ops/viterbi.py:
viterbi_composite_batch_pallas. The kernel is bitwise the plain version,
ops/viterbi.py:dense_forward, so viterbi_composite_batch_pallas is bitwise
ops/viterbi.py:viterbi_composite_batch (the "scan" backend).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The kernel takes every B >= 1, T >= 1 and
1 <= S <= MAX_STATES, with no shape fallback; past MAX_STATES it raises.
log_b may carry padded state columns (the emission kernel's layout), which
are skipped through its row stride.
"""
from __future__ import annotations

import torch

from ..viterbi import composite_transition_matrix, dense_decode, dense_forward, pack_coefs
from . import _build
from .trellis_scanfree import MAX_STATES, _check_cuda, trellis_backtrace

__all__ = ["MAX_STATES", "trellis_dense_branch", "trellis_dense_forward",
           "viterbi_composite_batch_pallas"]

BRANCHES = ("block", "cluster", "streamed")


def trellis_dense_branch(s: int) -> str:
    """The dense kernel's branch at s states: "block" (trans resident in one
    CTA's shared memory), "cluster" (a column slice resident in each CTA of
    a thread block cluster) or "streamed" (each CTA's slice read from L2
    every step). The kernel's launch plan decides."""
    return BRANCHES[_build.load().cs304_trellis_dense_branch(int(s))]


def trellis_dense_forward(log_b, trans, alpha0, lengths):
    """log_b (B, T, ld >= S) float32, trans (S, S) float32, alpha0 (B, S)
    float32, lengths (B,) int32 -> (alpha (B, S) float32, bp (B, T, S) int32
    with row 0 = -1)."""
    if not log_b.is_cuda:
        return dense_forward(log_b, trans, alpha0, lengths)
    b, t_total, ld = log_b.shape
    s = trans.shape[-1]
    for name, t in (("log_b", log_b), ("trans", trans), ("alpha0", alpha0)):
        _check_cuda(name, t, torch.float32)
    _check_cuda("lengths", lengths, torch.int32)
    if trans.shape != (s, s) or not 1 <= s <= min(ld, MAX_STATES):
        raise ValueError(
            f"trans {tuple(trans.shape)} vs log_b {tuple(log_b.shape)}: need "
            f"(S, S) with 1 <= S <= min(log_b.shape[2], {MAX_STATES})"
        )
    if alpha0.shape != (b, s) or lengths.shape != (b,) or b < 1 or t_total < 1:
        raise ValueError(
            f"alpha0 {tuple(alpha0.shape)} / lengths {tuple(lengths.shape)} vs "
            f"batch {b}, T {t_total}, S {s}"
        )
    if not (log_b.device == trans.device == alpha0.device == lengths.device):
        raise ValueError("log_b, trans, alpha0 and lengths are on different devices")
    lib = _build.load()
    alpha = torch.empty((b, s), dtype=torch.float32, device=log_b.device)
    bp = torch.empty((b, t_total, s), dtype=torch.int32, device=log_b.device)
    with torch.cuda.device(log_b.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_dense_forward(
            log_b.data_ptr(), trans.data_ptr(), alpha0.data_ptr(),
            lengths.data_ptr(), alpha.data_ptr(), bp.data_ptr(),
            b, t_total, s, ld, stream,
        )
    _build.check(code, "trellis_dense_forward")
    trellis_dense_forward.launches += 1
    return alpha, bp


trellis_dense_forward.launches = 0


def dense_decode_pallas(log_b, trans, coefs, lengths, quirk_backtrace: bool = True):
    """dense_decode through the dense forward kernel and K2's backtrace."""
    return dense_decode(log_b, trans, coefs, lengths, quirk_backtrace,
                        forward=trellis_dense_forward, backtrace=trellis_backtrace)


def viterbi_composite_batch_pallas(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool = True,
):
    """Drop-in for viterbi_composite_batch: log_b (B, T, S) float32,
    lengths (B,) -> (scores (B,), paths (B, T) int32)."""
    dev = log_b.device
    trans = composite_transition_matrix(log_a, lower_of_state, is_entry,
                                        is_exit, penalty, device=dev)
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return dense_decode_pallas(log_b.contiguous(), trans, coefs, lengths,
                               quirk_backtrace)
