"""The states-in-lanes fast trellis (K6): a wrapper of its signature over the
scan-free forward kernel (csrc/trellis_scanfree.cu).

Replaces cs304_tpu/ops/pallas/trellis_lanes.py (_kernel,
viterbi_lanes_forward_pallas), the forward of viterbi_composite_batch_fast
with at most 128 states in the TPU's lanes and 8 utterances in sublanes;
here it is the one forward kernel, trellis_forward, under the JAX signature
and limit.
"""
from __future__ import annotations

from .trellis_fast import composite_forward

S_LANES = 128  # the JAX kernel's limit: states in 128 lanes


def viterbi_lanes_forward_pallas(log_b, log_a, lower_of_state, is_entry, is_exit,
                                 penalty, lengths, t_blk: int = 32):
    """Returns (alpha_final (B, S), bp (B, T, S) int32), the forward of
    viterbi_composite_batch_fast, for S <= 128. ``t_blk`` (the TPU kernel's
    time block) is accepted and has no effect: the time loop runs inside
    one block per utterance."""
    return composite_forward(log_b, log_a, lower_of_state, is_entry, is_exit,
                             penalty, lengths, S_LANES, "viterbi_lanes_forward_pallas")
