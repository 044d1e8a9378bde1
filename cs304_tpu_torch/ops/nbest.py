"""N-best composite Viterbi: per-state top-K hypothesis beams.

The port of the JAX package's ops/nbest.py. Every state carries its K best
distinct path prefixes; a step merges the banded predecessors' beams (and,
for word-entry states, the shared top-K word-exit pool + penalty). The T
loop is a Python loop of whole-state-vector torch ops on one utterance.

jax.lax.top_k returns the lower index first on a tie; torch.topk promises no
order there, so the top K here is a stable descending sort (equal values
keep their index order), the same selection.

Hypotheses are distinct STATE paths; distinct paths may decode to the same
word string, and ``nbest_decode`` dedupes at the string level.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .viterbi import NEG, pack_coefs


def emissions_of(composite, features, log_b=None, device=None):
    """(log_b (T, S) float32 tensor, its device) for one utterance: a given
    tensor keeps its device; a given array goes to ``device`` (the card
    unless "cpu"); None scores the features with the composite's own
    single-Gaussian densities there."""
    if isinstance(log_b, torch.Tensor):
        return log_b, log_b.device
    dev = resolve_device(device)
    if log_b is None:
        return composite.log_likelihoods(np.asarray(features), device=dev), dev
    return torch.as_tensor(np.array(log_b, np.float32), device=dev), dev


def top_k(x: torch.Tensor, k: int):
    """The k largest values of the last axis and their indices, best first,
    the lower index first among equal values (jax.lax.top_k's order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def kbest_composite_forward(log_b, log_a, lower_of_state, is_entry, is_exit,
                            penalty, length=None, k: int = 4):
    """Forward pass with K hypotheses per state, on log_b's device.

    log_b (T, S) float32 -> (alpha (S, K) final scores, bp (T, S, K) int32
    encoding pred_state * K + pred_k, -1 on the seed frame)."""
    t_total, s = log_b.shape
    dev = log_b.device
    length = t_total if length is None else int(length)
    log_a = torch.as_tensor(log_a, dtype=torch.float32, device=dev)
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    diag_ne, sub1, sub2, diag_e = coefs[0], coefs[1], coefs[2], coefs[3]
    entry, exit_ = coefs[4] > 0, coefs[5] > 0
    diag = torch.diagonal(log_a)
    penalty = torch.as_tensor(penalty, dtype=torch.float32, device=dev)
    to = torch.arange(s, device=dev)
    lanes = torch.arange(k, device=dev)
    pred_state_ne = torch.stack([(to - 2).clamp(min=0), (to - 1).clamp(min=0), to], dim=1)
    both = entry & exit_
    slot_ids = to[:, None] * k + lanes[None, :]  # (S, K)
    # Single-state words (entry and exit): a pool candidate and a self-loop
    # candidate can carry the same predecessor; the pool keeps it when the
    # penalty is at least the self-loop (same alpha on both sides).
    pool_beats = (penalty >= diag)[:, None]
    neg_row = torch.full((1, k), NEG, device=dev)

    alpha = torch.full((s, k), NEG, device=dev)
    alpha[:, 0] = torch.where(entry, log_b[0] + coefs[6], NEG)
    bps = torch.empty((t_total, s, k), dtype=torch.int32, device=dev)
    bps[0] = -1
    for t in range(1, t_total):
        a1 = torch.cat([neg_row, alpha[:-1]], dim=0)
        a2 = torch.cat([neg_row, neg_row, alpha[:-2]], dim=0)[:s]
        cand_ne = torch.cat([a2 + sub2[:, None], a1 + sub1[:, None],
                             alpha + diag_ne[:, None]], dim=1)  # (S, 3K)
        top_ne, idx_ne = top_k(cand_ne, k)
        bp_ne = pred_state_ne.gather(1, idx_ne // k) * k + idx_ne % k

        pool = torch.where(exit_[:, None], alpha, NEG).reshape(-1)
        pool_top, pool_idx = top_k(pool, k)
        c_pen = pool_top + penalty
        c_self = alpha + diag_e[:, None]
        dup_self = both[:, None] & (slot_ids[:, :, None] == pool_idx[None, None, :]).any(-1)
        c_self = torch.where(dup_self & pool_beats, NEG, c_self)
        dup_pool = both[:, None] & (pool_idx[None, :] // k == to[:, None])
        c_pen_row = torch.where(dup_pool & ~pool_beats, NEG, c_pen[None, :].expand(s, k))
        top_e, idx_e = top_k(torch.cat([c_pen_row, c_self], dim=1), k)
        bp_pool = pool_idx[None, :].expand(s, k).gather(1, idx_e.clamp(max=k - 1))
        bp_e = torch.where(idx_e < k, bp_pool, to[:, None] * k + (idx_e - k))

        entry_col = entry[:, None]
        bps[t] = torch.where(entry_col, bp_e, bp_ne).to(torch.int32)
        if t < length:
            alpha = torch.where(entry_col, top_e, top_ne) + log_b[t][:, None]
    return alpha, bps


def nbest_paths(
    alpha: np.ndarray,
    backptrs: np.ndarray,
    is_exit: np.ndarray,
    length: int,
    n: int,
    quirk_backtrace: bool = True,
) -> List[Tuple[float, np.ndarray]]:
    """Backtrace the n best exit-terminated hypotheses (host-side).

    quirk_backtrace applies the same final-frame quirk as the 1-best decoder
    (path[L-1] = path[L-2]) so the n-best top-1 agrees with
    ContinuousDecoder.predict on every frame."""
    s, k = alpha.shape
    pool = np.where(is_exit[:, None], alpha, -np.inf).reshape(-1)
    order = np.argsort(pool)[::-1][:n]
    out = []
    for flat in order:
        if not np.isfinite(pool[flat]):
            break
        state, slot = divmod(int(flat), k)
        path = np.zeros(length, np.int64)
        path[-1] = state
        for t in range(length - 1, 0, -1):
            code = int(backptrs[t, state, slot])
            state, slot = divmod(code, k)
            path[t - 1] = state
        if quirk_backtrace and length >= 2:
            path[length - 1] = path[length - 2]
        out.append((float(pool[flat]), path))
    return out


def nbest_decode(composite, features, n: int = 4, beam_k: int | None = None,
                 quirk_backtrace: bool = True, log_b=None, device=None):
    """N-best word strings for one utterance's (T, D) features.

    Returns [(score, label_string), ...] best-first, deduped at the string
    level. log_b overrides the emissions (e.g. GMM densities from
    ContinuousDecoder.predict_nbest). Runs on ``device`` (the card unless
    "cpu"), or on log_b's device when it is a tensor."""
    if beam_k is None:
        beam_k = max(2 * n, 4)
    log_b, _dev = emissions_of(composite, features, log_b, device)
    alpha, backptrs = kbest_composite_forward(
        log_b, composite.log_a, composite.lower_of_state, composite.is_entry,
        composite.is_exit, composite.penalty, k=beam_k,
    )
    hyps = nbest_paths(
        alpha.cpu().numpy(), backptrs.cpu().numpy(), composite.is_exit,
        int(np.asarray(features).shape[0]), n * 2, quirk_backtrace=quirk_backtrace,
    )
    seen = {}
    for score, path in hyps:
        text = "".join(composite.path_to_labels(path))
        if text not in seen:
            seen[text] = score
        if len(seen) >= n:
            break
    return [(score, text) for text, score in sorted(
        seen.items(), key=lambda kv: -kv[1]
    )][:n]
