"""Banded sentence trellis (the embedded trainer's alignment): wrappers of the
sentence topology of the scan-free team kernel (csrc/trellis_scanfree.cu).

Replaces cs304_tpu/ops/pallas/trellis_banded.py (_forward_banded_kernel, and
its reuse of trellis_scanfree._backtrace_kernel).

- banded_decode (the training path) is ONE launch of the kernel's decode
  mode: forward, score alpha[final] and the backtrace with the reference
  quirk inside the kernel, with one-byte backpointer codes kept on chip
  (ops/viterbi.py:backpointer_codes is their plain specification).
  viterbi_banded_batch_scanfree runs it and is bitwise
  models/train_fused.py:_banded_trellis_batch.
- banded_forward is the backpointer mode: alpha and int32 backpointers,
  bitwise the plain version ops/viterbi.py:banded_sentence_forward, with an
  optional per-row t = 0 seed (lattice rescoring's arc scores,
  ops/rescore.py).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The kernel takes every B >= 1, T >= 1 and
1 <= S <= MAX_STATES, with no shape fallback (the Pallas kernel stops at 128
states and falls back to the scan); past MAX_STATES it raises.
"""
from __future__ import annotations

import torch

from ..viterbi import backtrace_batch, banded_sentence_forward
from . import _build
from .trellis_scanfree import MAX_STATES, _check_cuda, codes_scratch_bytes

__all__ = ["MAX_STATES", "banded_decode", "banded_forward", "final_states",
           "viterbi_banded_batch_scanfree"]


def _check_sentence(log_b, c0, c1, c2, lengths):
    """Validate the sentence kernel's CUDA inputs -> (B, T, S)."""
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
    return b, t_total, s


def banded_forward(log_b, c0, c1, c2, lengths, seed=None):
    """log_b (B, T, S) float32, c0/c1/c2 (B, S) float32 destination-indexed
    self/prev/skip log transitions, lengths (B,) int32, seed (B,) float32
    or None (alpha_0[0] = log_b[:, 0, 0] + seed where given, else the
    self-loop rule of banded_sentence_forward) ->
    (alpha (B, S) float32, bp (B, T, S) int32 with row 0 = -1)."""
    if not log_b.is_cuda:
        return banded_sentence_forward(log_b, c0, c1, c2, lengths, seed)
    b, t_total, s = _check_sentence(log_b, c0, c1, c2, lengths)
    if seed is not None:
        _check_cuda("seed", seed, torch.float32)
        if seed.shape != (b,) or seed.device != log_b.device:
            raise ValueError(f"seed {tuple(seed.shape)} on {seed.device} vs batch {b}")
    lib = _build.load()
    alpha = torch.empty((b, s), dtype=torch.float32, device=log_b.device)
    bp = torch.empty((b, t_total, s), dtype=torch.int32, device=log_b.device)
    with torch.cuda.device(log_b.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_sentence_forward(
            log_b.data_ptr(), c0.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            lengths.data_ptr(), seed.data_ptr() if seed is not None else None,
            alpha.data_ptr(), bp.data_ptr(), b, t_total, s, stream,
        )
    _build.check(code, "banded_forward")
    banded_forward.launches += 1
    return alpha, bp


banded_forward.launches = 0


def banded_decode(log_b, c0, c1, c2, lengths, final):
    """Forward + score + backtrace of the sentence trellis: log_b (B, T, S)
    float32, c0/c1/c2 (B, S), lengths (B,) int32, final (B,) int32 start
    states in [0, S) -> (scores (B,) = alpha[final], paths (B, T) int32 with
    the reference quirk). On CUDA tensors one launch of the decode mode."""
    if not log_b.is_cuda:
        alpha, bp = banded_sentence_forward(log_b, c0, c1, c2, lengths)
        scores = alpha.gather(1, final[:, None].to(torch.int64))[:, 0]
        return scores, backtrace_batch(bp, final, lengths, quirk=True)
    b, t_total, s = _check_sentence(log_b, c0, c1, c2, lengths)
    _check_cuda("final", final, torch.int32)
    if final.shape != (b,) or final.device != log_b.device:
        raise ValueError(f"final {tuple(final.shape)} on {final.device} vs batch {b}")
    lib = _build.load()
    dev = log_b.device
    scores = torch.empty((b,), dtype=torch.float32, device=dev)
    paths = torch.empty((b, t_total), dtype=torch.int32, device=dev)
    n_scratch = codes_scratch_bytes(b, t_total, s)
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev) if n_scratch else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_sentence_decode(
            log_b.data_ptr(), c0.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            lengths.data_ptr(), final.data_ptr(), scores.data_ptr(), paths.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b, t_total, s, stream,
        )
    _build.check(code, "banded_decode")
    banded_decode.launches += 1
    return scores, paths


banded_decode.launches = 0


def final_states(n_states, num_states: int) -> torch.Tensor:
    """(B,) sentence lengths in states -> int32 final state max(n - 1, 0),
    checked to lie inside the trellis (the kernel does not check)."""
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
    final = final_states(torch.as_tensor(n_states, device=dev), log_b.shape[2])
    return banded_decode(log_b.contiguous(), c0.contiguous(), c1.contiguous(),
                         c2.contiguous(), lengths, final.contiguous())
