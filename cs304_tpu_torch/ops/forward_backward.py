"""Log-space forward / backward recursions and posterior statistics.

A port of cs304_tpu/ops/forward_backward.py: the dense (S, S) log-semiring
recursions of isolated-word Baum-Welch (S = 5 a word), forward scoring and
the legacy trainer's Baum-Welch pass, where the JAX package runs lax.scans.
Here the clips are a batch dimension, and each call is ONE launch of the
FBD kernel (ops/cuda/forward_backward.py, csrc/forward_backward.cu) on a
CUDA tensor, in its forward, backward or posteriors mode; a CPU tensor runs
the kernel's plain version (fb_dense_plain). Nothing falls back: a CUDA
tensor the kernel does not take (S > MAX_FB_DENSE_STATES) raises.

Every function takes one sequence, log_b (T, S) with a scalar length, or a
batch, log_b (B, T, S) with lengths (B,). Padded frames are no-ops: steps
with t >= length pass the carry through, so a padded batch gives the
posteriors of its contents.
"""
from __future__ import annotations

import torch

from .cuda.forward_backward import fb_dense


def _batched(log_b, length):
    """(log_b (B, T, S), lengths (B,) int32, squeeze) for either form."""
    single = log_b.dim() == 2
    if single:
        log_b = log_b[None]
    b, t_total, _s = log_b.shape
    if length is None:
        lengths = torch.full((b,), t_total, dtype=torch.int32, device=log_b.device)
    else:
        lengths = torch.as_tensor(length, device=log_b.device).to(torch.int32).reshape(-1)
        lengths = lengths.expand(b) if lengths.numel() == 1 else lengths
    return log_b, lengths.contiguous(), single


def _run(mode, log_b, log_a, log_init, length, log_final):
    """fb_dense on contiguous float32 operands on log_b's device."""
    log_b, lengths, single = _batched(log_b, length)
    dev = log_b.device

    def f32(x):
        return None if x is None else torch.as_tensor(
            x, dtype=torch.float32, device=dev).contiguous()

    s = log_b.shape[2]
    if log_init is None:
        log_init = torch.zeros((s,), dtype=torch.float32, device=dev)
    out = fb_dense(f32(log_b), f32(log_a), f32(log_init), lengths, f32(log_final), mode)
    return out, single


def forward(log_b, log_a, log_init, length=None, log_final=None):
    """Forward recursion -> (log_alpha (T, S), log_likelihood), or batched
    ((B, T, S), (B,)).

    log_init (S,) holds the initial log-probabilities WITHOUT the t = 0
    emission (added here). The likelihood sums over states at t = length-1,
    weighted by log_final when given (pinning termination to the last state
    of a left-to-right HMM)."""
    (log_alpha, ll), single = _run("forward", log_b, log_a, log_init, length, log_final)
    return (log_alpha[0], ll[0]) if single else (log_alpha, ll)


def backward(log_b, log_a, length=None, log_final=None):
    """Backward recursion -> log_beta (T, S) (or (B, T, S)), with
    beta[length-1] = log_final (zeros when not given)."""
    log_beta, single = _run("backward", log_b, log_a, None, length, log_final)
    return log_beta[0] if single else log_beta


def forward_backward(log_b, log_a, log_init, length=None, log_final=None):
    """Full posteriors -> (gamma (T, S), xi_sum (S, S), log_likelihood), or
    batched ((B, T, S), (B, S, S), (B,)):
      gamma[t, s]   = P(state_t = s | obs), zero on padded frames;
      xi_sum[s, s'] = sum_t P(state_t = s, state_{t+1} = s' | obs).
    log_final conditions on the terminal state distribution (see forward).
    A log-likelihood of -inf (a pinned final no path reaches) gives +inf or
    NaN posteriors, as the JAX package does."""
    (gamma, xi_sum, ll), single = _run("posteriors", log_b, log_a, log_init, length,
                                       log_final)
    if single:
        return gamma[0], xi_sum[0], ll[0]
    return gamma, xi_sum, ll


def forward_log_likelihood(log_b, log_a, log_init, length=None):
    """Sequence log-likelihood under the model (the reference's deprecated
    tier's log_likelihood, deprecated/hidden_markov_model.py:181-206)."""
    return forward(log_b, log_a, log_init, length)[1]
