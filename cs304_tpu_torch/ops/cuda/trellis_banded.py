"""Banded sentence trellis (the embedded trainer's alignment): wrapper of the
CUDA forward kernel (csrc/trellis_banded.cu), decoded with K2's backtrace
kernel.

Replaces cs304_tpu/ops/pallas/trellis_banded.py (_forward_banded_kernel, and
its reuse of trellis_scanfree._backtrace_kernel). The kernel is bitwise the
plain version, ops/viterbi.py:banded_sentence_forward, and
viterbi_banded_batch_scanfree is bitwise
models/train_fused.py:_banded_trellis_batch.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The kernel takes every B >= 1, T >= 1 and
1 <= S <= MAX_STATES, with no shape fallback (the Pallas kernel stops at 128
states and falls back to the scan); past MAX_STATES it raises.
"""
from __future__ import annotations

import torch

from ..viterbi import banded_sentence_forward
from . import _build
from .trellis_scanfree import MAX_STATES, _check_cuda, trellis_backtrace

__all__ = ["MAX_STATES", "banded_forward", "viterbi_banded_batch_scanfree"]


def banded_forward(log_b, c0, c1, c2, lengths):
    """log_b (B, T, S) float32, c0/c1/c2 (B, S) float32 destination-indexed
    self/prev/skip log transitions, lengths (B,) int32 ->
    (alpha (B, S) float32, bp (B, T, S) int32 with row 0 = -1)."""
    if not log_b.is_cuda:
        return banded_sentence_forward(log_b, c0, c1, c2, lengths)
    b, t_total, s = log_b.shape
    _check_cuda("log_b", log_b, torch.float32)
    for name, c in (("c0", c0), ("c1", c1), ("c2", c2)):
        _check_cuda(name, c, torch.float32)
        if c.shape != (b, s):
            raise ValueError(f"{name} {tuple(c.shape)} vs log_b {tuple(log_b.shape)}")
    _check_cuda("lengths", lengths, torch.int32)
    if lengths.shape != (b,) or b < 1 or t_total < 1:
        raise ValueError(f"lengths {tuple(lengths.shape)} vs batch {b}, T {t_total}")
    if not 1 <= s <= MAX_STATES:
        raise ValueError(f"{s} sentence states; the kernel takes 1..{MAX_STATES}")
    if not (log_b.device == c0.device == c1.device == c2.device == lengths.device):
        raise ValueError("log_b, c0, c1, c2 and lengths are on different devices")
    lib = _build.load()
    alpha = torch.empty((b, s), dtype=torch.float32, device=log_b.device)
    bp = torch.empty((b, t_total, s), dtype=torch.int32, device=log_b.device)
    with torch.cuda.device(log_b.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_banded_forward(
            log_b.data_ptr(), c0.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            lengths.data_ptr(), alpha.data_ptr(), bp.data_ptr(),
            b, t_total, s, stream,
        )
    _build.check(code, "banded_forward")
    banded_forward.launches += 1
    return alpha, bp


banded_forward.launches = 0


def final_states(n_states, num_states: int) -> torch.Tensor:
    """(B,) sentence lengths in states -> int32 final state max(n - 1, 0),
    checked to lie inside the trellis (the backtrace kernel does not check)."""
    n_states = torch.as_tensor(n_states)
    if n_states.numel() and int(n_states.max()) > num_states:
        raise ValueError(f"n_states up to {int(n_states.max())} > S = {num_states}")
    return torch.clamp(n_states - 1, min=0).to(torch.int32)


def viterbi_banded_batch_scanfree(log_b, c0, c1, c2, lengths, n_states):
    """Drop-in for train_fused._banded_trellis_batch: log_b (B, T, S) f32,
    c0/c1/c2 (B, S), lengths (B,), n_states (B,) -> (scores (B,),
    paths (B, T) int32, with the reference final-frame quirk applied)."""
    dev = log_b.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    alpha, bp = banded_forward(log_b.contiguous(), c0.contiguous(),
                               c1.contiguous(), c2.contiguous(), lengths)
    final = final_states(torch.as_tensor(n_states, device=dev), log_b.shape[2])
    scores = alpha.gather(1, final[:, None].to(torch.int64))[:, 0]
    return scores, trellis_backtrace(bp, final, lengths, quirk=True)
