"""Batched full-covariance Gaussian log-densities, in two layouts.

Whitening (the parity reference):

    y[t, s, :] = L_s^{-1} (x_t - mu_s)
    logpdf[t, s] = -0.5 (D log 2pi + logdet Sigma_s + ||y[t, s]||^2)

Quadratic form (what the emission kernel computes):

    logpdf[t, s] = const_s + x_t . (P_s mu_s) + vec(x_t x_t^T) . vec(-0.5 P_s)

The quadratic form is a one-pass expansion and carries ~1e-3 absolute drift
against the whitening path in float32; it is not bit-comparable with it.
Everything is float32 with TF32 off.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import fp32_exact

_LOG_2PI = math.log(2.0 * math.pi)


class GaussianParams(NamedTuple):
    """means (S, D), whiten (S, D, D) = L_s^{-1}, log_norm (S,)."""

    means: torch.Tensor
    whiten: torch.Tensor
    log_norm: torch.Tensor


class GaussianQuadParams(NamedTuple):
    """neg_half_p (S, D*D) flattened -0.5 P_s, lin (D, S) P_s mu_s as columns,
    const (S,) log_norm_s - 0.5 mu_s^T P_s mu_s."""

    neg_half_p: torch.Tensor
    lin: torch.Tensor
    const: torch.Tensor


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _chol_and_log_norm(covariances: torch.Tensor):
    d = covariances.shape[-1]
    chol = torch.linalg.cholesky(covariances)
    log_det = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1
    )
    return chol, -0.5 * (d * _LOG_2PI + log_det)


def make_gaussian_params(means, covariances, device=None) -> GaussianParams:
    """(S, D) means, (S, D, D) covariances -> whitening parameters."""
    fp32_exact()
    means = _as_f32(means, device)
    covariances = _as_f32(covariances, means.device)
    chol, log_norm = _chol_and_log_norm(covariances)
    eye = torch.eye(means.shape[-1], dtype=torch.float32, device=means.device)
    whiten = torch.linalg.solve_triangular(
        chol, eye.expand_as(chol), upper=False
    )
    return GaussianParams(means=means, whiten=whiten, log_norm=log_norm)


def gaussian_log_pdf(params: GaussianParams, frames: torch.Tensor) -> torch.Tensor:
    """(..., T, D) frames -> (..., T, S) log-densities (whitening layout)."""
    fp32_exact()
    wx = torch.einsum("sde,...te->...tsd", params.whiten, frames)
    wmu = torch.einsum("sde,se->sd", params.whiten, params.means)
    y = wx - wmu
    quad = torch.sum(y * y, dim=-1)
    return params.log_norm - 0.5 * quad


def make_gaussian_quad_params(means, covariances, device=None) -> GaussianQuadParams:
    """(S, D) means, (S, D, D) covariances -> quadratic-form parameters."""
    fp32_exact()
    means = _as_f32(means, device)
    covariances = _as_f32(covariances, means.device)
    s, d = means.shape
    chol, log_norm = _chol_and_log_norm(covariances)
    eye = torch.eye(d, dtype=torch.float32, device=means.device)
    prec = torch.cholesky_solve(eye.expand_as(chol), chol, upper=False)
    p_mu = torch.einsum("sde,se->sd", prec, means)
    const = log_norm - 0.5 * torch.einsum("sd,sd->s", p_mu, means)
    return GaussianQuadParams(
        neg_half_p=(-0.5 * prec).reshape(s, d * d),
        lin=p_mu.T.contiguous(),
        const=const,
    )


def gaussian_log_pdf_quad(
    params: GaussianQuadParams, frames: torch.Tensor
) -> torch.Tensor:
    """(..., T, D) -> (..., T, S) via the quadratic form. A CUDA tensor runs
    the emission kernel (ops/cuda/emission.py); a CPU tensor its plain
    version, gaussian_log_pdf_quad_plain."""
    from .cuda.emission import emission, gaussian_log_pdf_quad_plain

    if not frames.is_cuda:
        return gaussian_log_pdf_quad_plain(params, frames)
    s = params.const.shape[0]
    d = frames.shape[-1]
    out = emission(
        frames.reshape(-1, d).contiguous(), params.neg_half_p.T.contiguous(),
        params.lin, params.const, num_states=s, s_pad=s,
    )
    return out.reshape(*frames.shape[:-1], s)
