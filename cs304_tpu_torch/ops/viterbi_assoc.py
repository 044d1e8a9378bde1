"""Viterbi via associative scan over max-plus matrix products.

A port of cs304_tpu/ops/viterbi_assoc.py. The sequential trellis has O(T)
depth. Viterbi is a tropical-semiring matrix chain — alpha_T = alpha_0 (x)
M_1 (x) ... (x) M_{T-1} with M_t[i, j] = trans[i, j] + log_b[t, j] and
(A (x) B)[i, j] = max_k A[i, k] + B[k, j] — so the forward pass parallelizes
to O(log T) depth with an associative scan (PAPERS.md "Temporal
Parallelization of Inference in Hidden Markov Models"). Work grows to
O(T S^3 log T).

The scan is jax.lax.associative_scan's up-sweep and down-sweep (pairs
combined, the half-length scan recursed, the even prefixes filled in) in
torch ops on the tensors' device, so the adds associate as JAX's do; they
associate differently from the sequential recursion, so scores agree with
it within float tolerance, and paths wherever no two predecessors tie. The
path is recovered from the per-step alphas as the JAX package's reverse
scan does, the lowest index winning a tie: one batched table of first-max
backpointers, bp[t, j] = argmax_i alphas[t-1, i] + trans[i, j]
(ops/viterbi.first_max, torch ops on the tensors' device), then ONE walk
of it by K2-bt (ops/cuda/trellis_scanfree.trellis_backtrace without the
quirk; its plain version backtrace_batch on a CPU tensor). The forward
stays torch ops, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch

from .cuda.trellis_scanfree import trellis_backtrace
from .viterbi import first_max


def _maxplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., S, S) tropical product: out[i, j] = max_k a[i, k] + b[k, j]."""
    return torch.amax(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def _associative_scan(fn, elems: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix scan of elems (N, ...) under the associative fn
    (earlier operand first), in jax.lax.associative_scan's order."""
    num = elems.shape[0]
    if num < 2:
        return elems
    reduced = fn(elems[0:-1:2], elems[1::2])
    odd = _associative_scan(fn, reduced)
    if num % 2 == 0:
        even = fn(odd[:-1], elems[2::2])
    else:
        even = fn(odd, elems[2::2])
    even = torch.cat([elems[0:1], even])
    out = torch.empty_like(elems)
    out[0::2] = even
    out[1::2] = odd
    return out


def viterbi_alphas_assoc(log_b: torch.Tensor, trans: torch.Tensor, alpha0: torch.Tensor):
    """All forward alphas in O(log T) depth.

    log_b (T, S), trans (S, S), alpha0 (S,) -> alphas (T, S) where alphas[t]
    equals the sequential max-plus recursion's alpha at step t (to float
    tolerance)."""
    steps = trans[None, :, :] + log_b[1:, None, :]  # M_t, t = 1 .. T-1
    prefix = _associative_scan(_maxplus_matmul, steps)  # (T-1, S, S)
    alphas_rest = torch.amax(alpha0[None, :, None] + prefix, dim=1)  # (T-1, S)
    return torch.cat([alpha0[None], alphas_rest], dim=0)


def viterbi_assoc(log_b: torch.Tensor, trans: torch.Tensor, alpha0: torch.Tensor,
                  final_mask: torch.Tensor):
    """Full Viterbi with associative-scan forward pass.

    final_mask (S,) bool marks admissible final states. Returns
    (score, path (T,) int32) with the standard (non-quirk) backtrace; every
    argmax takes the first (lowest) index on a tie."""
    alphas = viterbi_alphas_assoc(log_b, trans, alpha0)
    t_total, s = alphas.shape
    dev = alphas.device
    final_mask = torch.as_tensor(final_mask, device=dev).to(torch.bool)
    score, last = first_max(alphas[-1], final_mask)
    # bp[t, j] = the lowest i maximizing alphas[t-1, i] + trans[i, j].
    bp = torch.full((1, t_total, s), -1, dtype=torch.int32, device=dev)
    if t_total > 1:
        cand = (alphas[:-1, :, None] + trans[None]).transpose(1, 2)  # (T-1, to, from)
        bp[0, 1:] = first_max(cand, torch.ones_like(cand, dtype=torch.bool))[1]
    lengths = torch.full((1,), t_total, dtype=torch.int32, device=dev)
    path = trellis_backtrace(bp, last.reshape(1).contiguous(), lengths, quirk=False)
    return score, path[0]


def viterbi_composite_assoc(log_b, log_a, lower_of_state, is_entry, is_exit, penalty):
    """Composite continuous decoding with the O(log T)-depth forward pass.

    Same topology as ops.viterbi.viterbi_composite (entry seeding, exit
    termination, standard backtrace); the forward recursion is the
    associative scan. log_b (T, S) float32 -> (score, path (T,) int32) on
    log_b's device; identical results up to float-tie argmax order."""
    from .viterbi import composite_transition_matrix

    dev = log_b.device
    trans = composite_transition_matrix(log_a, lower_of_state, is_entry, is_exit,
                                        penalty, device=dev)
    log_a = torch.as_tensor(log_a, dtype=torch.float32, device=dev)
    diag = torch.diagonal(log_a)
    diag = torch.where(torch.isfinite(diag), diag, torch.zeros_like(diag))
    is_entry = torch.as_tensor(is_entry, device=dev).to(torch.bool)
    is_exit = torch.as_tensor(is_exit, device=dev).to(torch.bool)
    alpha0 = torch.where(is_entry, log_b[0] + diag, float("-inf"))
    return viterbi_assoc(log_b, trans, alpha0, is_exit)
