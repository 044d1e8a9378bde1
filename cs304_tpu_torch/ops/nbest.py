"""N-best composite Viterbi: per-state top-K hypothesis beams.

The port of the JAX package's ops/nbest.py. Every state carries its K best
distinct path prefixes; a step merges the banded predecessors' beams (and,
for word-entry states, the shared top-K word-exit pool + penalty). The
forward is ops/cuda/trellis_lattice.kbest_forward: one launch of the KBEST
kernel on the card, on the CPU its plain version (a Python loop over T of
whole-state-vector torch ops). The backtrace (nbest_paths) walks the
read-back backpointers on the host.

jax.lax.top_k returns the lower index first on a tie; torch.topk promises no
order there, so the top K is a stable descending sort (equal values keep
their index order), the same selection.

Hypotheses are distinct STATE paths; distinct paths may decode to the same
word string, and ``nbest_decode`` dedupes at the string level.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .cuda.trellis_lattice import kbest_forward, lattice_topology, top_k, topology_of  # noqa: F401


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


def kbest_composite_forward(log_b, log_a, lower_of_state, is_entry, is_exit,
                            penalty, length=None, k: int = 4, topology=None):
    """Forward pass with K hypotheses per state, on log_b's device.

    log_b (T, S) float32 -> (alpha (S, K) final scores, bp (T, S, K) int32
    encoding pred_state * K + pred_k, -1 on the seed frame). topology: the
    composite's LatticeTopology on log_b's device (trellis_lattice
    topology_of), else built from the arguments."""
    if topology is None:
        topology = lattice_topology(log_a, lower_of_state, is_entry, is_exit,
                                    device=log_b.device)
    return kbest_forward(log_b.contiguous(), topology, penalty, k, length)


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
        topology=topology_of(composite, log_b.device),
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
