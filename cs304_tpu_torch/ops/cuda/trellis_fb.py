"""The sentence forward-backward of embedded Baum-Welch training and the
E-step built on it: the wrappers of their CUDA kernel (csrc/trellis_fb.cu)
and their plain PyTorch versions.

- FB, ``banded_fb``: alpha, beta and ll. Replaces
  cs304_tpu/models/train_fused.py:_banded_fb_batch, two lax.scans of a
  log-semiring recursion over the sentence band (c0 self, c1 from prev, c2
  skip, indexed by destination state); the JAX package has no Pallas kernel
  of it. Written as plain PyTorch it is ~25 small launches a step in each
  direction; the kernel is one launch, the forward and the backward running
  as independent teams.
- The E-step, ``banded_fb_posteriors``: the state posteriors gamma, the
  per-diagonal xi sums and ll, which is all the Baum-Welch trainer reads of
  alpha and beta (JAX: gamma_of and the xi loop of _bw_body). One launch;
  alpha and beta never reach device memory as tensors of their own.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The kernels take every B >= 1, T >= 1 and
1 <= S <= MAX_FB_STATES; past that they raise.
"""
from __future__ import annotations

import torch

from . import _build
from .trellis_scanfree import _check_cuda

MAX_FB_STATES = 4096  # csrc/trellis_fb.cu: 32 warps of 32 lanes, 4 states a lane
NEG = float("-inf")


def lse3(a, b, c):
    """Elementwise logsumexp of three operands, -inf-safe, in the JAX
    package's order: m = max(max(a, b), c), then m + log((exp(a - m) +
    exp(b - m)) + exp(c - m)) where m is finite, else -inf."""
    m = torch.maximum(torch.maximum(a, b), c)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    out = m_safe + torch.log(
        torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe))
    return torch.where(fin, out, torch.full_like(out, NEG))


def shift_states(x, k: int, fill=NEG):
    """y[..., v] = x[..., v - k] along the last (state) axis: to the right
    for k > 0, to the left for k < 0; ``fill`` where v - k falls outside."""
    s = x.shape[-1]
    n = min(abs(k), s)
    pad = torch.full((*x.shape[:-1], n), fill, dtype=x.dtype, device=x.device)
    if k > 0:
        return torch.cat([pad, x[..., : s - n]], dim=-1)
    return torch.cat([x[..., n:], pad], dim=-1)


def banded_fb_plain(log_b, c0, c1, c2, lengths, final):
    """log_b (B, T, S) float32, c0/c1/c2 (B, S), lengths (B,), final (B,)
    states in [0, S) -> (log_alpha (B, T, S), log_beta (B, T, S), ll (B,)).

    alpha_0 is -inf except log_b[:, 0, 0]; steps t >= length keep the carry;
    ll = alpha_last[final]; beta starts from the final-state pin and
    restarts there at frames >= length - 1."""
    b, t_total, s = log_b.shape
    dev = log_b.device
    lengths = torch.as_tensor(lengths, device=dev)
    final = torch.as_tensor(final, device=dev).to(torch.int64)
    alpha = torch.full((b, s), NEG, dtype=log_b.dtype, device=dev)
    alpha[:, 0] = log_b[:, 0, 0]
    alphas = [alpha]
    for t in range(1, t_total):
        new_alpha = lse3(alpha + c0, shift_states(alpha, 1) + c1,
                         shift_states(alpha, 2) + c2) + log_b[:, t]
        alpha = torch.where((t < lengths)[:, None], new_alpha, alpha)
        alphas.append(alpha)
    ll = alpha.gather(1, final[:, None])[:, 0]

    beta_end = torch.where(torch.arange(s, device=dev)[None, :] == final[:, None],
                           torch.zeros((), dtype=log_b.dtype, device=dev),
                           torch.full((), NEG, dtype=log_b.dtype, device=dev))
    beta = beta_end
    betas = [beta_end]
    for t in range(t_total - 2, -1, -1):
        z = log_b[:, t + 1] + beta
        new_beta = lse3(z + c0, shift_states(z + c1, -1), shift_states(z + c2, -2))
        # Frames at/after length-1 restart from the final-state pin.
        beta = torch.where((t + 1 < lengths)[:, None], new_beta, beta_end)
        betas.append(beta)
    return torch.stack(alphas, dim=1), torch.stack(betas[::-1], dim=1), ll


def _check_args(log_b, c0, c1, c2, lengths, final):
    """Raise on what the kernels do not take; return (B, T, S)."""
    b, t_total, s = log_b.shape
    _check_cuda("log_b", log_b, torch.float32)
    for name, c in (("c0", c0), ("c1", c1), ("c2", c2)):
        _check_cuda(name, c, torch.float32)
        if c.shape != (b, s):
            raise ValueError(f"{name} {tuple(c.shape)} vs log_b {tuple(log_b.shape)}")
    for name, v in (("lengths", lengths), ("final", final)):
        _check_cuda(name, v, torch.int32)
        if v.shape != (b,):
            raise ValueError(f"{name} {tuple(v.shape)} vs batch {b}")
    if b < 1 or t_total < 1:
        raise ValueError(f"empty batch: B={b}, T={t_total}")
    if not 1 <= s <= MAX_FB_STATES:
        raise ValueError(f"{s} sentence states; the kernel takes 1..{MAX_FB_STATES}")
    dev = log_b.device
    if any(x.device != dev for x in (c0, c1, c2, lengths, final)):
        raise ValueError("log_b, c0, c1, c2, lengths and final are on different devices")
    return b, t_total, s


def banded_fb(log_b, c0, c1, c2, lengths, final):
    """The sentence forward-backward (see banded_fb_plain): log_b (B, T, S)
    float32, c0/c1/c2 (B, S) float32, lengths (B,) int32, final (B,) int32
    -> (log_alpha, log_beta (B, T, S) float32, ll (B,) float32). On CUDA
    tensors one launch of FB; a final state outside [0, S) gives ll = -inf
    and an all -inf beta_end there."""
    if not log_b.is_cuda:
        return banded_fb_plain(log_b, c0, c1, c2, lengths, final)
    b, t_total, s = _check_args(log_b, c0, c1, c2, lengths, final)
    dev = log_b.device
    lib = _build.load()
    alpha = torch.empty((b, t_total, s), dtype=torch.float32, device=dev)
    beta = torch.empty((b, t_total, s), dtype=torch.float32, device=dev)
    ll = torch.empty((b,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_fb(
            log_b.data_ptr(), c0.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            lengths.data_ptr(), final.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
            ll.data_ptr(), b, t_total, s, stream,
        )
    _build.check(code, "banded_fb")
    banded_fb.launches += 1
    return alpha, beta, ll


banded_fb.launches = 0


def banded_fb_posteriors_plain(log_b, c0, c1, c2, lengths, final):
    """The Baum-Welch E-step, plain: banded_fb_plain, then the posteriors.
    -> (gamma (B, T, S), xi (B, 3, S), ll (B,)).

    valid = isfinite(ll), ll_c = ll where valid else 0;
    gamma[b, t, v] = exp((alpha + beta) - ll_c) for t < length of a valid
    utterance, +0 elsewhere; xi[b, k, v] (k = 0 self, 1 from prev, 2 skip,
    destination-indexed) = the sum over pairs t + 1 < length of a valid
    utterance of exp(((alpha_t[v - k] + c_k[v]) + (log_b[t + 1, v] +
    beta_{t + 1}[v])) - ll_c), alpha_t[v - k] = -inf for v < k, taken from
    the last pair down to the first, one add a pair from +0 (the kernel's
    order)."""
    alpha, beta, ll = banded_fb_plain(log_b, c0, c1, c2, lengths, final)
    b, t_total, s = log_b.shape
    dev = log_b.device
    lengths = torch.as_tensor(lengths, device=dev)
    valid = torch.isfinite(ll)
    ll_c = torch.where(valid, ll, torch.zeros_like(ll))
    steps = torch.arange(t_total, device=dev)
    mask = (steps[None, :] < lengths[:, None]) & valid[:, None]
    gamma = torch.exp(alpha + beta - ll_c[:, None, None])
    gamma = torch.where(mask[..., None], gamma, torch.zeros_like(gamma))

    pair_mask = ((steps[None, :-1] + 1 < lengths[:, None]) & valid[:, None])[..., None]
    zb = log_b[:, 1:] + beta[:, 1:]  # (B, T-1, S)
    xi = torch.zeros((b, 3, s), dtype=log_b.dtype, device=dev)
    for k, ck in enumerate((c0, c1, c2)):
        a_shift = shift_states(alpha[:, :-1], k) if k else alpha[:, :-1]
        log_xi = a_shift + ck[:, None, :] + zb - ll_c[:, None, None]
        terms = torch.where(pair_mask, torch.exp(log_xi), torch.zeros_like(log_xi))
        acc = torch.zeros((b, s), dtype=log_b.dtype, device=dev)
        for t in range(t_total - 2, -1, -1):
            acc = acc + terms[:, t]
        xi[:, k] = acc
    return gamma, xi, ll


def banded_fb_posteriors(log_b, c0, c1, c2, lengths, final):
    """The Baum-Welch E-step (see banded_fb_posteriors_plain): log_b
    (B, T, S) float32, c0/c1/c2 (B, S) float32, lengths (B,) int32, final
    (B,) int32 -> (gamma (B, T, S), xi (B, 3, S), ll (B,)) float32. On CUDA
    tensors one launch of the kernel's E-step mode, bitwise its plain
    version; a final state outside [0, S) gives ll = -inf, and the
    utterance counts nothing."""
    if not log_b.is_cuda:
        return banded_fb_posteriors_plain(log_b, c0, c1, c2, lengths, final)
    b, t_total, s = _check_args(log_b, c0, c1, c2, lengths, final)
    dev = log_b.device
    lib = _build.load()
    gamma = torch.empty((b, t_total, s), dtype=torch.float32, device=dev)
    xi = torch.empty((b, 3, s), dtype=torch.float32, device=dev)
    ll = torch.empty((b,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_trellis_fb_posteriors(
            log_b.data_ptr(), c0.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            lengths.data_ptr(), final.data_ptr(), gamma.data_ptr(), xi.data_ptr(),
            ll.data_ptr(), b, t_total, s, stream,
        )
    _build.check(code, "banded_fb_posteriors")
    banded_fb_posteriors.launches += 1
    return gamma, xi, ll


banded_fb_posteriors.launches = 0
