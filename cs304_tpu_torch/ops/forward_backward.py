"""Log-space forward / backward recursions and posterior statistics.

A port of cs304_tpu/ops/forward_backward.py: the dense (S, S) log-semiring
recursions of isolated-word Baum-Welch (S = 5 a word), where the JAX package
runs lax.scans. Here the clips are a batch dimension and the T steps a
Python loop; this is off the embedded trainer's path (its sentence trellis is
models/train_fused.py:_banded_fb_batch and the kernel ops/cuda/trellis_fb.py),
so it has no kernel of its own.

Every function takes one sequence, log_b (T, S) with a scalar length, or a
batch, log_b (B, T, S) with lengths (B,). Padded frames are no-ops: steps
with t >= length pass the carry through, so a padded batch gives the
posteriors of its contents.
"""
from __future__ import annotations

import torch

from .logmath import logsumexp


def _batched(log_b, length):
    """(log_b (B, T, S), lengths (B,) int64, squeeze) for either form."""
    single = log_b.dim() == 2
    if single:
        log_b = log_b[None]
    b, t_total, _s = log_b.shape
    if length is None:
        lengths = torch.full((b,), t_total, dtype=torch.int64, device=log_b.device)
    else:
        lengths = torch.as_tensor(length, device=log_b.device).to(torch.int64).reshape(-1)
        lengths = lengths.expand(b) if lengths.numel() == 1 else lengths
    return log_b, lengths, single


def _forward(log_b, log_a, log_init, lengths, log_final):
    b, t_total, s = log_b.shape
    alpha = log_init + log_b[:, 0]
    rows = [alpha]
    for t in range(1, t_total):
        new_alpha = logsumexp(alpha[:, :, None] + log_a, axis=1) + log_b[:, t]
        alpha = torch.where((t < lengths)[:, None], new_alpha, alpha)
        rows.append(alpha)
    log_alpha = torch.stack(rows, dim=1)
    last = alpha if log_final is None else alpha + log_final
    return log_alpha, logsumexp(last, axis=1)


def _backward(log_b, log_a, lengths, log_final):
    b, t_total, s = log_b.shape
    beta_end = (torch.zeros((s,), dtype=log_b.dtype, device=log_b.device)
                if log_final is None
                else torch.as_tensor(log_final, dtype=log_b.dtype, device=log_b.device))
    beta_end = beta_end.expand(b, s)
    beta = beta_end
    rows = [beta_end]
    for t in range(t_total - 2, -1, -1):
        # beta[t] = logsum_s' a[s, s'] + b[t+1, s'] + beta[t+1, s']
        new_beta = logsumexp(log_a + (log_b[:, t + 1] + beta)[:, None, :], axis=2)
        # Frames at/after length-1 restart from the final-state weights.
        beta = torch.where((t + 1 < lengths)[:, None], new_beta, beta_end)
        rows.append(beta)
    return torch.stack(rows[::-1], dim=1)


def forward(log_b, log_a, log_init, length=None, log_final=None):
    """Forward recursion -> (log_alpha (T, S), log_likelihood), or batched
    ((B, T, S), (B,)).

    log_init (S,) holds the initial log-probabilities WITHOUT the t = 0
    emission (added here). The likelihood sums over states at t = length-1,
    weighted by log_final when given (pinning termination to the last state
    of a left-to-right HMM)."""
    log_b, lengths, single = _batched(log_b, length)
    log_alpha, ll = _forward(log_b, log_a, log_init, lengths, log_final)
    return (log_alpha[0], ll[0]) if single else (log_alpha, ll)


def backward(log_b, log_a, length=None, log_final=None):
    """Backward recursion -> log_beta (T, S) (or (B, T, S)), with
    beta[length-1] = log_final (zeros when not given)."""
    log_b, lengths, single = _batched(log_b, length)
    log_beta = _backward(log_b, log_a, lengths, log_final)
    return log_beta[0] if single else log_beta


def forward_backward(log_b, log_a, log_init, length=None, log_final=None):
    """Full posteriors -> (gamma (T, S), xi_sum (S, S), log_likelihood), or
    batched ((B, T, S), (B, S, S), (B,)):
      gamma[t, s]   = P(state_t = s | obs), zero on padded frames;
      xi_sum[s, s'] = sum_t P(state_t = s, state_{t+1} = s' | obs).
    log_final conditions on the terminal state distribution (see forward)."""
    log_b, lengths, single = _batched(log_b, length)
    b, t_total, s = log_b.shape
    log_alpha, ll = _forward(log_b, log_a, log_init, lengths, log_final)
    log_beta = _backward(log_b, log_a, lengths, log_final)
    ts = torch.arange(t_total, device=log_b.device)
    frame_mask = (ts[None, :] < lengths[:, None])[..., None]
    log_gamma = log_alpha + log_beta - ll[:, None, None]
    gamma = torch.where(frame_mask, torch.exp(log_gamma), torch.zeros_like(log_gamma))
    # xi[t, s, s'] over transitions t -> t+1 with t+1 < length.
    log_xi = (log_alpha[:, :-1, :, None] + log_a[None, None]
              + (log_b[:, 1:] + log_beta[:, 1:])[:, :, None, :]
              - ll[:, None, None, None])
    pair_mask = (ts[None, 1:] < lengths[:, None])[..., None, None]
    xi_sum = torch.sum(torch.where(pair_mask, torch.exp(log_xi),
                                   torch.zeros_like(log_xi)), dim=1)
    if single:
        return gamma[0], xi_sum[0], ll[0]
    return gamma, xi_sum, ll


def forward_log_likelihood(log_b, log_a, log_init, length=None):
    """Sequence log-likelihood under the model (the reference's deprecated
    tier's log_likelihood, deprecated/hidden_markov_model.py:181-206)."""
    return forward(log_b, log_a, log_init, length)[1]
