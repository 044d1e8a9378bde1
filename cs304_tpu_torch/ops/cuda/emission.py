"""Quadratic-form Gaussian emissions: wrappers of the CUDA kernels
(csrc/emission.cu, csrc/emission_split.cu), their plain PyTorch versions,
and the fused decode.

The kernels compute

    out[n, s] = x2_n . nhp[:, s] + x_n . lin[:, s] + const[s],
    x2_n = vec(x_n x_n^T),

building x2 on chip, never in device memory; padded state columns hold 0.
Three precision tiers, as the JAX package's gaussian_log_pdf_fused has:

- "highest" (``emission``, csrc/emission.cu): float32 throughout. Replaces
  cs304_tpu/ops/pallas/emission.py:_emission_kernel, _emission_kernel_blocked
  and _emission_kernel_selmm (x2_mode "selmm" builds the same x2 on the
  TPU's MXU; here both modes run this one kernel, bitwise the same output).
- "high" (``emission_split``, 3 passes): the quadratic term as three bf16
  tensor-core passes hi.hi + hi.lo + lo.hi over operands split into bf16
  hi / lo, the linear term float32. Replaces _emission_kernel_high and
  _emission_kernel_blocked_high.
- "default" (``emission_split``, 1 pass): one bf16 pass hi.hi for the
  quadratic term and one bf16 pass for the linear term: what the TPU runs
  for _emission_kernel at Precision.DEFAULT. The JAX package measured it as
  a negative (0.825 vs 0.9625 exact-sequence on a trained 100-word
  checkpoint) and offers it all the same; so does the port.

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
MAX_DIM = 64  # the kernels stage a (64, D) frame tile; D <= 64
PASSES = {"high": 3, "default": 1}  # bf16 passes of the split kernel's tiers
SPLIT_TILE = 64  # the split kernel's state tile: s_pad must be a multiple
X2_MODES = ("concat", "selmm")


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
    f32 = torch.float32
    _check_operands(frames, (("frames", frames, f32, (n, d)),
                             ("nhp", nhp, f32, (d * d, s_pad)),
                             ("lin", lin, f32, (d, s_pad)),
                             ("const", const, f32, (s_pad,))))
    _check_shape(n, d, num_states, s_pad)
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


def split_hi_lo(x):
    """float32 -> (hi, lo) bfloat16 with hi = bf16(x) and
    lo = bf16(x - float(hi)), both rounded to nearest even (the JAX
    package's _split_hi_lo)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def emission_split_plain(frames, nhp_hi, nhp_lo, lin, const, passes: int):
    """The plain version of the split kernel: frames (N, D) float32, nhp_hi
    / nhp_lo (D*D, s_pad) bfloat16 (nhp_lo unused at 1 pass), lin (D, s_pad)
    and const (s_pad,) float32 -> (N, s_pad). The bf16 operands are
    multiplied in float32 matmuls with TF32 off, where their products are
    exact; x2 is materialized."""
    fp32_exact()
    n, d = frames.shape
    x2 = (frames[:, :, None] * frames[:, None, :]).reshape(n, d * d)
    x2_hi, x2_lo = split_hi_lo(x2)
    quad = x2_hi.float() @ nhp_hi.float()
    if passes == 3:
        quad = (quad + x2_hi.float() @ nhp_lo.float()) + x2_lo.float() @ nhp_hi.float()
        lin_term = frames @ lin
    else:
        lin_term = frames.to(torch.bfloat16).float() @ lin.to(torch.bfloat16).float()
    return quad + lin_term + const


def _check_operands(frames, specs):
    """Device, dtype, shape and contiguity of a kernel's operands:
    specs = ((name, tensor, dtype, shape), ...)."""
    for name, t, dtype, shape in specs:
        if not t.is_cuda or t.device != frames.device:
            raise ValueError(f"{name} must be on {frames.device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_shape(n, d, num_states, s_pad):
    if not (1 <= d <= MAX_DIM and n >= 1 and 1 <= num_states <= s_pad):
        raise ValueError(
            f"unsupported emission shape N={n} D={d} S={num_states} "
            f"s_pad={s_pad} (need N >= 1, 1 <= D <= {MAX_DIM}, S <= s_pad)"
        )


def emission_split(frames, nhp_hi, nhp_lo, lin, const, num_states: int,
                   s_pad: int, passes: int):
    """The "high" (passes=3) or "default" (passes=1) tier: frames (N, D)
    float32 -> (N, s_pad) float32, zeros in columns num_states..s_pad-1.
    nhp_hi / nhp_lo (D*D, s_pad) bfloat16 from split_hi_lo of
    pack_quad_params' nhp (nhp_lo may be None at 1 pass); lin (D, s_pad),
    const (s_pad,) float32."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if not frames.is_cuda:
        out = emission_split_plain(frames, nhp_hi, nhp_lo, lin, const, passes)
        out[:, num_states:] = 0.0
        return out
    n, d = frames.shape
    bf16 = torch.bfloat16
    specs = [("frames", frames, torch.float32, (n, d)),
             ("nhp_hi", nhp_hi, bf16, (d * d, s_pad)),
             ("lin", lin, torch.float32, (d, s_pad)),
             ("const", const, torch.float32, (s_pad,))]
    if passes == 3:
        if nhp_lo is None:
            raise ValueError("the 3-pass tier needs nhp_lo")
        specs.append(("nhp_lo", nhp_lo, bf16, (d * d, s_pad)))
    _check_operands(frames, specs)
    _check_shape(n, d, num_states, s_pad)
    split = (nhp_hi, nhp_lo) if passes == 3 else (nhp_hi,)
    if s_pad % SPLIT_TILE or any(t.data_ptr() % 16 for t in split):
        raise ValueError(f"the split kernel needs s_pad a multiple of {SPLIT_TILE} "
                         "and 16-byte aligned nhp_hi / nhp_lo")
    lib = _build.load()
    out = torch.empty((n, s_pad), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_emission_split(
            frames.data_ptr(), nhp_hi.data_ptr(),
            nhp_lo.data_ptr() if passes == 3 else None,
            lin.data_ptr(), const.data_ptr(), out.data_ptr(),
            n, d, num_states, s_pad, passes, stream,
        )
    _build.check(code, "emission_split")
    emission_split.launches += 1
    return out


emission_split.launches = 0


def tier_emission(frames, nhp, lin, const, num_states: int, s_pad: int,
                  precision: str = "highest", nhp_split=None):
    """One precision tier's emissions on packed parameters: "highest" runs
    the float32 kernel, "high" / "default" the split kernel (nhp_split, the
    cached split_hi_lo(nhp), saves the split)."""
    if precision == "highest":
        return emission(frames, nhp, lin, const, num_states, s_pad)
    if precision not in PASSES:
        raise ValueError(f"unknown precision {precision!r}")
    nhp_hi, nhp_lo = nhp_split if nhp_split is not None else split_hi_lo(nhp)
    return emission_split(frames, nhp_hi, nhp_lo, lin, const, num_states,
                          s_pad, PASSES[precision])


def gaussian_log_pdf_fused(means, covariances, frames_flat, s_pad: int = LANES,
                           precision: str = "highest", x2_mode: str = "concat"):
    """(N, D) frames -> (N, s_pad) emission log-densities, states padded with
    zero columns to s_pad (a multiple of 128). precision "highest", "high"
    or "default"; x2_mode "concat" or "selmm" (both build x2 the same way
    here and give bitwise the same output; as in the JAX package, it has no
    effect past 128 states or at "high")."""
    if x2_mode not in X2_MODES:
        raise ValueError(f"unknown x2_mode {x2_mode!r}; expected one of {X2_MODES}")
    if s_pad % LANES:
        raise ValueError(f"s_pad {s_pad} must be a multiple of {LANES}")
    s = int(means.shape[0])
    if s > s_pad:
        raise ValueError(f"{s} states do not fit s_pad={s_pad}")
    nhp, lin, const = pack_quad_params(means, covariances, s_pad,
                                       device=frames_flat.device)
    return tier_emission(frames_flat.contiguous(), nhp, lin, const, s, s_pad,
                         precision)


def decode_batch_fused(
    means, covs, log_a, lower_of_state, is_entry, is_exit, penalty,
    batch_feats, lengths, quirk_backtrace: bool = True,
    precision: str = "highest",
):
    """The fused decode: an emission kernel of the precision tier on
    (B*T, D) frames, then the scan-free trellis pair on the padded
    (B, T, s_pad) emissions. batch_feats (B, T, D) float32, lengths (B,) ->
    (scores (B,), paths (B, T) int32), on batch_feats' device."""
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
