"""The batch-in-lanes fast trellis (K5): a wrapper of its signature over the
scan-free forward kernel (csrc/trellis_scanfree.cu).

Replaces cs304_tpu/ops/pallas/trellis_fast.py (_kernel,
viterbi_fast_forward_pallas). That kernel computes the forward of
viterbi_composite_batch_fast (the scan-free forward's function) with the
batch laid across the TPU's 128 lanes and at most 64 states in sublanes, a
TPU register layout with no Hopper counterpart; here it is the one forward
kernel, trellis_forward, under the JAX signature and limit.
"""
from __future__ import annotations

import torch

from ..viterbi import pack_coefs
from .trellis_scanfree import trellis_forward

S_PAD = 64  # the JAX kernel's limit: states in 64 sublanes


def composite_forward(log_b, log_a, lower_of_state, is_entry, is_exit,
                      penalty, lengths, max_states: int, name: str):
    """trellis_forward on raw topology arrays: log_b (B, T, S) float32,
    lengths (B,) -> (alpha (B, S) float32, bp (B, T, S) int32, row 0 = -1).
    Raises ValueError past ``max_states``, where the JAX kernel asserts."""
    s = log_b.shape[2]
    if s > max_states:
        raise ValueError(f"composite has {s} states; {name} supports <= {max_states}")
    dev = log_b.device
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return trellis_forward(log_b.contiguous(), coefs, penalty, lengths)


def viterbi_fast_forward_pallas(log_b, log_a, lower_of_state, is_entry, is_exit,
                                penalty, lengths, t_blk: int = 16):
    """Returns (alpha_final (B, S), bp (B, T, S) int32), the forward of
    viterbi_composite_batch_fast, for S <= 64. ``t_blk`` (the TPU kernel's
    time block) is accepted and has no effect: the time loop runs inside
    one block per utterance."""
    return composite_forward(log_b, log_a, lower_of_state, is_entry, is_exit,
                             penalty, lengths, S_PAD, "viterbi_fast_forward_pallas")
