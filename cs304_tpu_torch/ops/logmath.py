"""Log-domain and max-plus (tropical) primitives.

A port of cs304_tpu/ops/logmath.py. The conventions are the JAX package's:
an all -inf slice has logsumexp -inf (never NaN), max_plus_vecmat returns the
first-max argmax, and safe_log maps 0 to -inf.
"""
from __future__ import annotations

import numpy as np
import torch

# A finite stand-in for -inf where arithmetic between two masked values could
# give NaN (-inf - -inf); a true identity for max stays -inf.
NEG_INF = np.float32(np.finfo(np.float32).min)


def max_plus_vecmat(alpha: torch.Tensor, log_m: torch.Tensor):
    """One tropical vector-matrix product: new_alpha[s] = max_{s'} alpha[s']
    + log_m[s', s], with the first-max argmax (np.argmax's order).

    alpha (S,), log_m (S, S) -> (new_alpha (S,), argmax (S,) int32)."""
    scores = alpha[:, None] + log_m
    best = torch.max(scores, dim=0).values
    # First index holding the max (torch.argmax does not promise which).
    idx = torch.arange(scores.shape[0], device=scores.device)[:, None]
    hit = torch.where(scores == best[None, :], idx, scores.shape[0])
    return best, torch.min(hit, dim=0).values.to(torch.int32)


def logsumexp(x: torch.Tensor, axis=None, keepdims: bool = False) -> torch.Tensor:
    """Numerically stable log-sum-exp that gives -inf for all -inf slices."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    m = torch.amax(x, dim=axis, keepdim=True)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    s = torch.log(torch.sum(torch.exp(x - m_safe), dim=axis, keepdim=True)) + m_safe
    s = torch.where(fin, s, m)
    return s if keepdims else s.squeeze(axis)


def log_plus_vecmat(alpha: torch.Tensor, log_m: torch.Tensor) -> torch.Tensor:
    """One log-semiring vector-matrix product (a forward-algorithm step)."""
    return logsumexp(alpha[:, None] + log_m, axis=0)


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """log that maps 0 to -inf without NaN from negative-zero noise.
    Subnormals count as 0, as they do where the JAX package runs (XLA's CPU
    and TPU backends flush them to zero)."""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x >= tiny, torch.log(torch.clamp(x, min=tiny)),
                       torch.full_like(x, float("-inf")))
