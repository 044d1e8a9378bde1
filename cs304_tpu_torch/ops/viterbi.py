"""Composite Viterbi over the flattened word-HMM state space, plain PyTorch.

This is the plain version of the scan-free trellis kernels
(ops/cuda/trellis_scanfree.py) and their bitwise specification. The composite
topology gives every state at most three banded predecessors and every word
entry one shared candidate (best word exit + penalty), so a step is O(S):

  non-entry j:  max(alpha[j-2]+A[j-2,j], alpha[j-1]+A[j-1,j], alpha[j]+A[j,j])
  entry e:      max(best_exit + penalty, alpha[e]+A[e,e])

Tie-breaks: skip-2, then skip-1, then self on >=; an exit beats the entry's
self-loop on an exact tie; the lowest exit index wins among exits, and when
every exit is -inf the index is 0. Steps t >= length leave alpha unchanged.

Backtrace parity note: the reference's backtrace drops the true final state,
so path[L-1] == path[L-2]; ``quirk_backtrace=True`` (the default) reproduces
that. Backpointers are int32. The time loop is a Python loop.
"""
from __future__ import annotations

import torch

NEG = float("-inf")
_PAIR_PENALTY_NOT_PORTED = (
    "per-pair (bigram LM) penalties are not ported yet "
    "(ROADMAP Queue 1, slice 4: ops/lm.py)"
)


def pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=None) -> torch.Tensor:
    """The O(S) banded coefficients as an (8, S) float32 tensor, rows:
    diag_ne, sub1, sub2, diag_e, is_entry, is_exit, diag_init, unused.
    sub1/sub2 are the skip-1/-2 transitions with the band floored at the
    word's entry state; diag_init replaces a non-finite self-loop by 0 for
    the t=0 row."""
    log_a = torch.as_tensor(log_a, dtype=torch.float32, device=device)
    dev = log_a.device
    lower = torch.as_tensor(lower_of_state, device=dev).to(torch.int64)
    entry = torch.as_tensor(is_entry, device=dev).to(torch.bool)
    exit_ = torch.as_tensor(is_exit, device=dev).to(torch.bool)
    s = log_a.shape[0]
    to = torch.arange(s, device=dev)
    diag = torch.diagonal(log_a)
    neg = torch.full((s,), NEG, dtype=torch.float32, device=dev)
    sub1 = torch.where(
        (to >= 1) & (to - 1 >= lower) & ~entry,
        log_a[torch.clamp(to - 1, min=0), to], neg,
    )
    sub2 = torch.where(
        (to >= 2) & (to - 2 >= lower) & ~entry,
        log_a[torch.clamp(to - 2, min=0), to], neg,
    )
    return torch.stack([
        torch.where(~entry, diag, neg),
        sub1,
        sub2,
        torch.where(entry, diag, neg),
        entry.to(torch.float32),
        exit_.to(torch.float32),
        torch.where(torch.isfinite(diag), diag, torch.zeros_like(diag)),
        torch.zeros_like(diag),
    ])


def first_max(values: torch.Tensor, mask: torch.Tensor):
    """Masked max over the last axis and the LOWEST index attaining it;
    with every masked value -inf (or nothing masked) the index is 0, as a
    first-max argmax over the full (-inf-filled) row gives."""
    masked = torch.where(mask, values, torch.full_like(values, NEG))
    best = masked.max(dim=-1, keepdim=True).values
    lanes = torch.arange(values.shape[-1], device=values.device)
    idx = torch.where(masked == best, lanes, values.shape[-1]).min(dim=-1).values
    return best.squeeze(-1), idx.to(torch.int32)


def entry_update(alpha, is_exit, penalty, pair_penalty=None,
                 word_of_state=None, uppers=None):
    """Word-entry predecessor candidate: alpha (B, S) ->
    (c_pen (B, 1) = best exit + penalty, best_exit_idx (B, 1) int32).
    Only the flat penalty is ported."""
    if pair_penalty is not None:
        raise NotImplementedError(_PAIR_PENALTY_NOT_PORTED)
    best, idx = first_max(alpha, is_exit)
    return (best + penalty)[:, None], idx[:, None]


def forward_fast(log_b, coefs, penalty, lengths):
    """Forward recursion. log_b (B, T, >=S) float32 (columns past S are
    ignored), coefs (8, S) from pack_coefs, lengths (B,) ->
    (alpha (B, S) float32, backpointers (B, T, S) int32 with row 0 = -1)."""
    b, t_total = log_b.shape[:2]
    s = coefs.shape[1]
    dev = log_b.device
    diag_ne, sub1, sub2, diag_e = coefs[0], coefs[1], coefs[2], coefs[3]
    entry, exit_ = coefs[4] > 0, coefs[5] > 0
    to = torch.arange(s, device=dev, dtype=torch.int32)
    to1 = torch.clamp(to - 1, min=0)
    to2 = torch.clamp(to - 2, min=0)
    penalty = torch.as_tensor(penalty, dtype=torch.float32, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)

    alpha = torch.where(entry, log_b[:, 0, :s] + coefs[6], NEG)
    bps = torch.empty((b, t_total, s), dtype=torch.int32, device=dev)
    bps[:, 0] = -1
    for t in range(1, t_total):
        a1 = torch.full_like(alpha, NEG)
        a1[:, 1:] = alpha[:, :-1]
        a2 = torch.full_like(alpha, NEG)
        a2[:, 2:] = alpha[:, :-2]
        c0 = alpha + diag_ne
        c1 = a1 + sub1
        c2 = a2 + sub2
        v12 = torch.maximum(c1, c0)
        val_ne = torch.maximum(c2, v12)
        bp_ne = torch.where(c2 >= v12, to2, torch.where(c1 >= c0, to1, to))

        c_pen, best_exit_idx = entry_update(alpha, exit_, penalty)
        c_self = alpha + diag_e
        val_e = torch.maximum(c_pen, c_self)
        bp_e = torch.where(c_pen >= c_self, best_exit_idx, to)

        new_alpha = torch.where(entry, val_e, val_ne) + log_b[:, t, :s]
        bps[:, t] = torch.where(entry, bp_e, bp_ne)
        live = (t < lengths)[:, None]
        alpha = torch.where(live, new_alpha, alpha)
    return alpha, bps


def backtrace_batch(backptrs, best, lengths, quirk: bool = True):
    """Reverse walk: backptrs (B, T, S) int32, best (B,) start states,
    lengths (B,) -> paths (B, T) int32. path[t] is the state held when
    stepping back from t (emitted before stepping), so entries at
    t >= length hold the start state; path[0] is the final state."""
    b, t_total, _ = backptrs.shape
    dev = backptrs.device
    lengths = torch.as_tensor(lengths, device=dev)
    state = best.to(torch.int64)
    path = torch.empty((b, t_total), dtype=torch.int32, device=dev)
    for t in range(t_total - 1, 0, -1):
        path[:, t] = state.to(torch.int32)
        nxt = backptrs[:, t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = torch.where(t <= lengths - 1, nxt, state)
    path[:, 0] = state.to(torch.int32)
    if quirk:
        path = apply_quirk(path, lengths)
    return path


def apply_quirk(paths, lengths):
    """path[len-1] = path[len-2] per row (indices clamped at 0; a length past
    T writes nothing)."""
    t_total = paths.shape[1]
    lengths = torch.as_tensor(lengths, device=paths.device).to(torch.int64)
    last = torch.clamp(lengths - 1, min=0)
    second = torch.clamp(lengths - 2, min=0, max=t_total - 1)
    rows = torch.nonzero(last < t_total)[:, 0]
    out = paths.clone()
    out[rows, last[rows]] = paths[rows, second[rows]]
    return out


def _backtrace(backptrs, best_state, length, quirk: bool = True):
    """One utterance: backptrs (T, S), best_state scalar, length scalar ->
    path (T,) int32."""
    best = torch.as_tensor(best_state, device=backptrs.device).reshape(1)
    length = torch.as_tensor(length, device=backptrs.device).reshape(1)
    return backtrace_batch(backptrs[None], best, length, quirk)[0]


def viterbi_composite_batch_fast(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool = True, pair_penalty=None, word_of_state=None,
    uppers=None, beam=None,
):
    """Composite batch decode: log_b (B, T, S) float32, lengths (B,) ->
    (scores (B,) float32, paths (B, T) int32), on log_b's device."""
    if pair_penalty is not None:
        raise NotImplementedError(_PAIR_PENALTY_NOT_PORTED)
    if beam is not None:
        raise NotImplementedError(
            "beam pruning is not ported yet (ROADMAP Queue 1, slice 4)"
        )
    dev = log_b.device
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    alpha, bps = forward_fast(log_b, coefs, penalty, lengths)
    scores, best = first_max(alpha, coefs[5] > 0)
    return scores, backtrace_batch(bps, best, lengths, quirk_backtrace)
