"""The dense log-semiring forward-backward (FBD): the wrapper of its CUDA
kernel (csrc/forward_backward.cu) and its plain PyTorch version.

Replaces cs304_tpu/ops/forward_backward.py:forward and :backward, two
lax.scans of a log-semiring vector-matrix product over a dense (S, S)
transition matrix, and the posteriors forward_backward forms from them (the
JAX package has no Pallas kernel of it). It serves isolated-word Baum-Welch
(models/gmm_hmm.py:_bw_stats), forward scoring
(GMMWordHMM.forward_score) and the legacy trainer's Baum-Welch pass
(models/train_continuous.py:_stats_pass_bw). Written as plain PyTorch it is
~13 small launches a step in each direction; the kernel is one launch a
call, in one of three modes:

- ``"forward"``: (log_alpha (B, T, S), ll (B,));
- ``"backward"``: log_beta (B, T, S);
- ``"posteriors"``: (gamma (B, T, S), xi (B, S, S), ll (B,)), alpha and
  beta only in a scratch of the launch.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The kernel takes every B >= 1, T >= 1 and
1 <= S <= MAX_FB_DENSE_STATES; past that it raises. It sums over log_a's
finite entries only, in the plain version's order: on the card the two are
bitwise equal. Which build runs is fb_dense_plan(S).
"""
from __future__ import annotations

import torch

from . import _build
from .trellis_scanfree import _check_cuda

MAX_FB_DENSE_STATES = 128  # csrc/forward_backward.cu: the b128 build's states
MODES = ("forward", "backward", "posteriors")
# The kernel's builds, in csrc/forward_backward.cu's BUILDS order: name ->
# (most states, threads a sequence, sequences a block). w8 / w16 / w32:
# 8 / 16 / 32 lanes of one warp a sequence, shuffles, no barrier; b64 /
# b128: a block a sequence, a thread a state, one barrier a step.
FBD_BUILDS = {"w8": (8, 8, 4), "w16": (16, 16, 2), "w32": (32, 32, 1), "b64": (64, 64, 1),
              "b128": (128, 128, 1)}

__all__ = ["FBD_BUILDS", "MAX_FB_DENSE_STATES", "MODES", "fb_dense", "fb_dense_plain",
           "fb_dense_plan", "lse_ascending"]


def fb_dense_plan(s: int) -> str:
    """The build that runs S states (csrc/forward_backward.cu's plan()):
    the narrowest build that holds them."""
    if not 1 <= s <= MAX_FB_DENSE_STATES:
        raise ValueError(f"{s} states; the kernel takes 1..{MAX_FB_DENSE_STATES}")
    return next(name for name, shape in FBD_BUILDS.items() if s <= shape[0])


def lse_ascending(x, dim: int):
    """logsumexp of x over ``dim`` in the kernel's order: m = max; m itself
    where m is not finite (-inf, never NaN); else log(s) + m with s the sum
    of exp(x_i - m) taken over ascending i from +0, one add at a time."""
    m = torch.amax(x, dim=dim)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    terms = torch.exp(x - m_safe.unsqueeze(dim))
    s = torch.zeros_like(m)
    for i in range(x.shape[dim]):
        s = s + terms.select(dim, i)
    return torch.where(fin, torch.log(s) + m_safe, m)


def fb_dense_plain(log_b, log_a, log_init, lengths, log_final=None, mode="posteriors"):
    """The plain version of every mode (module docstring): log_b (B, T, S),
    log_a (S, S), log_init (S,), lengths (B,), log_final (S,) or None.

    forward:  alpha_0 = log_init + log_b[0]; alpha_t = lse_i(alpha[i] +
              log_a[i, j]) + log_b[t, j] for t < length, else the carry;
              ll = lse(alpha_{T-1} + log_final), or lse(alpha_{T-1}).
    backward: beta_{T-1} = log_final (zeros without it); beta_t[i] =
              lse_j(log_a[i, j] + (log_b[t+1, j] + beta_{t+1}[j])) for
              t + 1 < length, else that end row.
    posteriors: gamma = exp((alpha + beta) - ll) on frames t < length, +0
              past them; xi[i, j] = the sum over pairs t + 1 < length, in
              ascending t from +0, of exp(((alpha_t[i] + log_a[i, j]) +
              (log_b[t+1, j] + beta_{t+1}[j])) - ll). ll = -inf is not
              substituted: those cells are +inf or NaN, as the JAX
              package's.
    Each lse is lse_ascending."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, t_total, s = log_b.shape
    dev = log_b.device
    lengths = torch.as_tensor(lengths, device=dev)
    alpha = beta = ll = None
    if mode != "backward":
        x = log_init + log_b[:, 0]
        rows = [x]
        for t in range(1, t_total):
            new = lse_ascending(x[:, :, None] + log_a, 1) + log_b[:, t]
            x = torch.where((t < lengths)[:, None], new, x)
            rows.append(x)
        alpha = torch.stack(rows, dim=1)
        ll = lse_ascending(x if log_final is None else x + log_final, 1)
        if mode == "forward":
            return alpha, ll
    end = (torch.zeros((b, s), dtype=log_b.dtype, device=dev) if log_final is None
           else log_final.expand(b, s))
    y = end
    rows = [end]
    for t in range(t_total - 2, -1, -1):
        z = log_b[:, t + 1] + y
        new = lse_ascending(log_a + z[:, None, :], 2)
        y = torch.where((t + 1 < lengths)[:, None], new, end)
        rows.append(y)
    beta = torch.stack(rows[::-1], dim=1)
    if mode == "backward":
        return beta

    steps = torch.arange(t_total, device=dev)
    live = (steps[None, :] < lengths[:, None])[..., None]
    gamma = torch.exp((alpha + beta) - ll[:, None, None])
    gamma = torch.where(live, gamma, torch.zeros_like(gamma))
    zb = log_b[:, 1:] + beta[:, 1:]
    xi = torch.zeros((b, s, s), dtype=log_b.dtype, device=dev)
    for t in range(t_total - 1):
        term = torch.exp(((alpha[:, t, :, None] + log_a) + zb[:, t, None, :])
                         - ll[:, None, None])
        xi = xi + torch.where((t + 1 < lengths)[:, None, None], term, torch.zeros_like(term))
    return gamma, xi, ll


def _check_args(log_b, log_a, log_init, lengths, log_final):
    """Raise on what the kernel does not take; return (B, T, S)."""
    _check_cuda("log_b", log_b, torch.float32)
    if log_b.dim() != 3:
        raise ValueError(f"log_b must be (B, T, S), got {tuple(log_b.shape)}")
    b, t_total, s = log_b.shape
    named = [("log_a", log_a, (s, s)), ("log_init", log_init, (s,))]
    if log_final is not None:
        named.append(("log_final", log_final, (s,)))
    for name, x, shape in named:
        _check_cuda(name, x, torch.float32)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} vs log_b {tuple(log_b.shape)}")
    _check_cuda("lengths", lengths, torch.int32)
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} vs batch {b}")
    if b < 1 or t_total < 1:
        raise ValueError(f"empty batch: B={b}, T={t_total}")
    if not 1 <= s <= MAX_FB_DENSE_STATES:
        raise ValueError(f"{s} states; the kernel takes 1..{MAX_FB_DENSE_STATES}")
    if any(x.device != log_b.device for _n, x, _s in named) or lengths.device != log_b.device:
        raise ValueError("log_b, log_a, log_init, log_final and lengths are on different devices")
    return b, t_total, s


def fb_dense(log_b, log_a, log_init, lengths, log_final=None, mode="posteriors"):
    """FBD (see fb_dense_plain): log_b (B, T, S) float32, log_a (S, S),
    log_init (S,), log_final (S,) or None float32, lengths (B,) int32, all
    contiguous -> the mode's outputs. On CUDA tensors one launch, of
    fb_dense_plan(S)'s build."""
    if not log_b.is_cuda:
        return fb_dense_plain(log_b, log_a, log_init, lengths, log_final, mode)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, t_total, s = _check_args(log_b, log_a, log_init, lengths, log_final)
    dev = log_b.device
    lib = _build.load()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    alpha = empty(b, t_total, s) if mode != "backward" else None
    beta = empty(b, t_total, s) if mode != "forward" else None
    gamma = empty(b, t_total, s) if mode == "posteriors" else None
    xi = empty(b, s, s) if mode == "posteriors" else None
    ll = empty(b) if mode != "backward" else None

    def ptr(x):
        return x.data_ptr() if x is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_fb_dense(
            MODES.index(mode), log_b.data_ptr(), log_a.data_ptr(), log_init.data_ptr(),
            ptr(log_final), lengths.data_ptr(), ptr(alpha), ptr(beta), ptr(gamma), ptr(xi),
            ptr(ll), b, t_total, s, stream,
        )
    _build.check(code, "fb_dense")
    fb_dense.launches += 1
    if mode == "forward":
        return alpha, ll
    if mode == "backward":
        return beta
    return gamma, xi, ll


fb_dense.launches = 0
