"""Quadratic-form Gaussian emissions: wrapper of the CUDA kernel
(csrc/emission.cu), its plain PyTorch version, and the fused decode.

Replaces cs304_tpu/ops/pallas/emission.py (_emission_kernel,
_emission_kernel_blocked; precision "highest"). The kernel computes

    out[n, s] = x2_n . nhp[:, s] + x_n . lin[:, s] + const[s],
    x2_n = vec(x_n x_n^T),

building x2 on chip, never in device memory; padded state columns hold 0.
Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from ...device import fp32_exact
from ..gaussian import GaussianQuadParams, make_gaussian_quad_params
from ..viterbi import pack_coefs
from . import _build
from .trellis_scanfree import scanfree_decode

LANES = 128
MAX_DIM = 64  # the kernel stages a (64, D) frame tile; D <= 64


def emission_plain(frames, nhp, lin, const):
    """frames (N, D), nhp (D*D, s_pad), lin (D, s_pad), const (s_pad,) ->
    (N, s_pad). x2 is materialized: (N, D*D) floats."""
    fp32_exact()
    n, d = frames.shape
    x2 = (frames[:, :, None] * frames[:, None, :]).reshape(n, d * d)
    return x2 @ nhp + frames @ lin + const


def gaussian_log_pdf_quad_plain(params: GaussianQuadParams, frames):
    """(..., T, D) -> (..., T, S): the plain version of the emission kernel on
    unpadded quadratic-form parameters."""
    d = frames.shape[-1]
    out = emission_plain(frames.reshape(-1, d), params.neg_half_p.T,
                         params.lin, params.const)
    return out.reshape(*frames.shape[:-1], params.const.shape[0])


def emission(frames, nhp, lin, const, num_states: int, s_pad: int):
    """frames (N, D) float32 -> (N, s_pad) float32 log-densities of the first
    ``num_states`` states, zeros in columns num_states..s_pad-1. nhp
    (D*D, s_pad), lin (D, s_pad) and const (s_pad,) are zero past
    num_states (pack_quad_params)."""
    if not frames.is_cuda:
        out = emission_plain(frames, nhp, lin, const)
        out[:, num_states:] = 0.0
        return out
    n, d = frames.shape
    for name, t, shape in (("frames", frames, (n, d)),
                           ("nhp", nhp, (d * d, s_pad)),
                           ("lin", lin, (d, s_pad)),
                           ("const", const, (s_pad,))):
        if not t.is_cuda or t.device != frames.device:
            raise ValueError(f"{name} must be on {frames.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (1 <= d <= MAX_DIM and n >= 1 and 1 <= num_states <= s_pad):
        raise ValueError(
            f"unsupported emission shape N={n} D={d} S={num_states} "
            f"s_pad={s_pad} (need N >= 1, 1 <= D <= {MAX_DIM}, S <= s_pad)"
        )
    lib = _build.load()
    out = torch.empty((n, s_pad), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_emission_quad(
            frames.data_ptr(), nhp.data_ptr(), lin.data_ptr(),
            const.data_ptr(), out.data_ptr(), n, d, num_states, s_pad, stream,
        )
    _build.check(code, "emission")
    emission.launches += 1
    return out


emission.launches = 0


def pack_quad_params(means, covariances, s_pad: int, device=None):
    """Quadratic-form parameters padded to s_pad state columns:
    (nhp (D*D, s_pad), lin (D, s_pad), const (s_pad,)), zero past S."""
    qp = make_gaussian_quad_params(means, covariances, device=device)
    s, dd = qp.neg_half_p.shape
    d = qp.lin.shape[0]
    dev = qp.lin.device
    nhp = torch.zeros((dd, s_pad), dtype=torch.float32, device=dev)
    nhp[:, :s] = qp.neg_half_p.T
    lin = torch.zeros((d, s_pad), dtype=torch.float32, device=dev)
    lin[:, :s] = qp.lin
    const = torch.zeros((s_pad,), dtype=torch.float32, device=dev)
    const[:s] = qp.const
    return nhp, lin, const


def _check_precision(precision: str) -> None:
    if precision in ("high", "default"):
        raise NotImplementedError(
            f"emission precision {precision!r} is not ported yet (ROADMAP "
            "Queue 2: K1-high / the default-tier A/B)"
        )
    if precision != "highest":
        raise ValueError(f"unknown precision {precision!r}")


def gaussian_log_pdf_fused(means, covariances, frames_flat, s_pad: int = LANES,
                           precision: str = "highest"):
    """(N, D) frames -> (N, s_pad) emission log-densities, states padded with
    zero columns to s_pad (a multiple of 128)."""
    _check_precision(precision)
    if s_pad % LANES:
        raise ValueError(f"s_pad {s_pad} must be a multiple of {LANES}")
    s = int(means.shape[0])
    if s > s_pad:
        raise ValueError(f"{s} states do not fit s_pad={s_pad}")
    nhp, lin, const = pack_quad_params(means, covariances, s_pad,
                                       device=frames_flat.device)
    return emission(frames_flat.contiguous(), nhp, lin, const, s, s_pad)


def decode_batch_fused(
    means, covs, log_a, lower_of_state, is_entry, is_exit, penalty,
    batch_feats, lengths, quirk_backtrace: bool = True,
    precision: str = "highest",
):
    """The fused decode: emission kernel on (B*T, D) frames, then the
    scan-free trellis pair on the padded (B, T, s_pad) emissions.
    batch_feats (B, T, D) float32, lengths (B,) -> (scores (B,), paths
    (B, T) int32), on batch_feats' device."""
    b, t_total, d = batch_feats.shape
    s = int(means.shape[0])
    s_pad = -(-s // LANES) * LANES
    dev = batch_feats.device
    log_b = gaussian_log_pdf_fused(
        means, covs, batch_feats.reshape(b * t_total, d), s_pad=s_pad,
        precision=precision,
    ).reshape(b, t_total, s_pad)
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return scanfree_decode(log_b, coefs, penalty, lengths, quirk_backtrace)
