"""MFCC front-end on tensors, matching the reference's librosa pipeline:

  melspectrogram(n_mels=40, n_fft=320, hop=160, fmin=133.33, fmax=6855.4976)
  -> power_to_db(ref=max, amin=1e-10, top_db=80)
  -> DCT-II (ortho, 13 coefficients)
  -> Savitzky-Golay deltas (width 9, mode='interp')
  -> concat([normalize(mfcc), d1, d2])  (T, 39)

The default normalization is the reference's per-frame one (mean/std across
the 13 coefficients of each frame; deltas left raw). Framing is a reshape of
the centre-padded signal into g-sample blocks (g = hop when hop * 2 == n_fft)
and the real DFT is a matmul against windowed cos/sin matrices, or
torch.fft.rfft with ``spectrogram="fft"``. Per-utterance reductions (the dB
reference max, the top_db clamp, the right edge of the deltas) are masked by
the true frame count, so padding never changes a clip's features.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..device import fp32_exact

# ----------------------------------------------------------------------------
# Static constants (host NumPy)
# ----------------------------------------------------------------------------


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    return np.where(
        log_t, min_log_mel + np.log(np.maximum(f, 1e-20) / min_log_hz) / logstep, mels
    )


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sr: float, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-style mel filterbank (librosa.filters.mel(htk=False,
    norm='slaney')). Returns (n_mels, 1 + n_fft // 2)."""
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def dct_ortho_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in), as scipy.fft.dct(norm='ortho')."""
    n = np.arange(n_in)
    k = np.arange(n_out)[:, None]
    m = np.cos(np.pi * k * (2 * n[None, :] + 1) / (2 * n_in))
    m *= np.sqrt(2.0 / n_in)
    m[0] *= np.sqrt(0.5)
    return m.astype(np.float32)


def _savgol_operators(width: int, polyorder: int, deriv: int):
    """Savitzky-Golay operators of scipy.signal.savgol_filter(mode='interp'):
    (interior (width,), edge_left (half, width), edge_right (half, width))."""
    half = width // 2
    x = np.arange(width, dtype=np.float64)
    vand = np.vander(x, polyorder + 1, increasing=True)
    pinv = np.linalg.pinv(vand)

    def deriv_eval_row(t: float) -> np.ndarray:
        row = np.zeros(polyorder + 1)
        for j in range(deriv, polyorder + 1):
            fac = 1.0
            for r in range(deriv):
                fac *= j - r
            row[j] = fac * t ** (j - deriv)
        return row

    interior = deriv_eval_row(half) @ pinv
    edge_left = np.stack([deriv_eval_row(t) @ pinv for t in range(half)])
    edge_right = np.stack(
        [deriv_eval_row(t) @ pinv for t in range(half + 1, width)]
    )
    return (
        interior.astype(np.float32),
        edge_left.astype(np.float32),
        edge_right.astype(np.float32),
    )


@dataclass(frozen=True)
class MFCCConfig:
    """Front-end hyperparameters (defaults = the reference's)."""

    sample_rate: float = 16000.0
    n_fft: int = 320
    hop_length: int = 160
    n_mels: int = 40
    n_mfcc: int = 13
    fmin: float = 133.33
    fmax: float = 6855.4976
    amin: float = 1e-10
    top_db: float = 80.0
    delta_width: int = 9
    normalize_eps: float = 1e-8
    # "matmul" (windowed DFT as float32 matmuls) or "fft" (torch.fft.rfft).
    spectrogram: str = "matmul"
    # Only "highest" (float32, TF32 off) is ported.
    precision: str = "highest"
    # "per_frame" (the reference's), "cmn" or "cmvn" (per utterance, masked).
    normalization: str = "per_frame"


def _constants(cfg: MFCCConfig):
    n_bins = 1 + cfg.n_fft // 2
    n = np.arange(cfg.n_fft)
    hann = (0.5 - 0.5 * np.cos(2 * np.pi * n / cfg.n_fft)).astype(np.float32)
    k = np.arange(n_bins)
    ang = 2 * np.pi * np.outer(n, k) / cfg.n_fft
    dft_cos = (np.cos(ang) * hann[:, None]).astype(np.float32)
    dft_sin = (-np.sin(ang) * hann[:, None]).astype(np.float32)
    mel_fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    dct_m = dct_ortho_matrix(cfg.n_mfcc, cfg.n_mels)
    d1 = _savgol_operators(cfg.delta_width, 1, 1)
    d2 = _savgol_operators(cfg.delta_width, 2, 2)
    return hann, dft_cos, dft_sin, mel_fb, dct_m, d1, d2


_CONST_CACHE: dict = {}


def _cached_constants(cfg: MFCCConfig):
    """Host NumPy constants per config (immutable; shared by all callers)."""
    if cfg not in _CONST_CACHE:
        _CONST_CACHE[cfg] = _constants(cfg)
    return _CONST_CACHE[cfg]


def _framing_blocks(cfg: MFCCConfig) -> int:
    """Block size g: the largest unit tiling the hop grid and the centre pad."""
    return math.gcd(math.gcd(cfg.n_fft, cfg.hop_length), cfg.n_fft // 2)


def _gather_frames(signal: torch.Tensor, cfg: MFCCConfig, t_frames: int):
    """(B, L) -> (B, t_frames, n_fft) centered frames, zero padding."""
    pad = cfg.n_fft // 2
    padded = torch.nn.functional.pad(signal, (pad, cfg.n_fft))
    idx = (
        cfg.hop_length * torch.arange(t_frames, device=signal.device)[:, None]
        + torch.arange(cfg.n_fft, device=signal.device)[None, :]
    )
    return padded[:, idx]


def _half_blocks(signal: torch.Tensor, hop: int):
    """hop * 2 == n_fft: the centre-padded signal as (B, n, hop) blocks;
    frame t is blocks t and t + 1."""
    length = signal.shape[-1]
    pad_tail = hop + (-(length + 2 * hop) % hop) + hop
    padded = torch.nn.functional.pad(signal, (hop, pad_tail))
    return padded.reshape(signal.shape[0], -1, hop)


def _power_spectrogram(signal: torch.Tensor, cfg: MFCCConfig, consts):
    """(B, L) -> (B, T, n_bins) power spectrogram, centered, zero pad_mode."""
    hann, dft_cos, dft_sin = consts
    hop = cfg.hop_length
    length = signal.shape[-1]
    t_frames = 1 + length // hop
    if cfg.spectrogram == "fft":
        if hop * 2 == cfg.n_fft:
            blocks = _half_blocks(signal, hop)
            frames = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=2)[:, :t_frames]
        else:
            frames = _gather_frames(signal, cfg, t_frames)
        spec = torch.fft.rfft(frames * hann, dim=-1)
        return spec.real ** 2 + spec.imag ** 2
    if hop * 2 == cfg.n_fft:
        # Frame t = blocks[t] ++ blocks[t+1]: each block meets each half of
        # the DFT matrix once, half the FLOPs of the (T, n_fft) product.
        blk = _half_blocks(signal, hop)[:, : t_frames + 1]
        re_lo = blk @ dft_cos[:hop]
        re_hi = blk @ dft_cos[hop:]
        im_lo = blk @ dft_sin[:hop]
        im_hi = blk @ dft_sin[hop:]
        re = re_lo[:, :-1] + re_hi[:, 1:]
        im = im_lo[:, :-1] + im_hi[:, 1:]
        return re * re + im * im
    g = _framing_blocks(cfg)
    if g >= 16:
        # n_fft / g strided-slice matmuls over g-sample blocks.
        stride = hop // g
        parts = cfg.n_fft // g
        pad_left = cfg.n_fft // 2
        n_blocks = (t_frames - 1) * stride + parts
        pad_right = max(0, n_blocks * g - pad_left - length)
        padded = torch.nn.functional.pad(signal, (pad_left, pad_right))
        blocks = padded[:, : n_blocks * g].reshape(signal.shape[0], n_blocks, g)
        re = im = 0.0
        for b in range(parts):
            part = blocks[:, b : b + (t_frames - 1) * stride + 1 : stride]
            re = re + part @ dft_cos[b * g : (b + 1) * g]
            im = im + part @ dft_sin[b * g : (b + 1) * g]
        return re * re + im * im
    frames = _gather_frames(signal, cfg, t_frames)
    re = frames @ dft_cos
    im = frames @ dft_sin
    return re * re + im * im


def _power_to_db(mel_power, frame_mask, cfg: MFCCConfig):
    """librosa.power_to_db(ref=np.max) with the per-utterance max masked to
    real frames. mel_power (B, T, n_mels), frame_mask (B, T) bool."""
    log10 = torch.log(torch.tensor(10.0, dtype=torch.float32, device=mel_power.device))
    mask = frame_mask[:, :, None]
    log_spec = 10.0 * torch.log(torch.clamp(mel_power, min=cfg.amin)) / log10
    masked = torch.where(mask, mel_power, 0.0)
    ref = masked.amax(dim=(1, 2), keepdim=True)
    log_spec = log_spec - 10.0 * torch.log(torch.clamp(ref, min=cfg.amin)) / log10
    peak = torch.where(mask, log_spec, float("-inf")).amax(dim=(1, 2), keepdim=True)
    return torch.maximum(log_spec, peak - cfg.top_db)


def _savgol_interp(x, n_frames, ops, width: int):
    """Savitzky-Golay filter along time with scipy's mode='interp' edges.
    x (B, T, C) padded; n_frames (B,) true frame counts."""
    interior, edge_left, edge_right = ops
    half = width // 2
    t_total = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, half, half))
    y = sum(float(interior[k]) * xp[:, k : k + t_total] for k in range(width))
    left = torch.stack([
        sum(float(edge_left[r, k]) * x[:, k] for k in range(width))
        for r in range(half)
    ], dim=1)
    y = torch.cat([left, y[:, half:]], dim=1)
    # Right edge: the last `width` real frames of each clip map onto its
    # last `half` rows.
    xr = torch.nn.functional.pad(x, (0, 0, 0, width))
    rows = torch.arange(t_total, device=x.device)[None, :, None]
    j0 = torch.clamp(n_frames.to(torch.int64) - width, min=0)
    gather_idx = j0[:, None, None].expand(-1, 1, x.shape[2])
    n_last = (n_frames.to(torch.int64) - half)[:, None, None]
    out = y
    for r in range(half):
        s_r = sum(float(edge_right[r, k]) * xr[:, k : k + t_total]
                  for k in range(width))
        val = s_r.gather(1, gather_idx)  # (B, 1, C)
        out = torch.where(rows == n_last + r, val, out)
    return out


def _normalize_per_frame(mfcc, cfg: MFCCConfig):
    """Mean/std across the coefficient axis of each frame (population std)."""
    mean = torch.mean(mfcc, dim=-1, keepdim=True)
    std = torch.sqrt(torch.mean((mfcc - mean) ** 2, dim=-1, keepdim=True))
    return (mfcc - mean) / (std + cfg.normalize_eps)


def mfcc_features_batch(signals, num_samples, cfg: MFCCConfig = MFCCConfig()):
    """(B, L) padded signals + (B,) true lengths -> ((B, T, 39) features,
    (B,) int32 frame counts), T = 1 + L // hop; rows past a clip's count are 0.
    Runs on the signals' device."""
    if cfg.precision != "highest":
        raise NotImplementedError(
            f"MFCC precision {cfg.precision!r} is not ported yet (only 'highest')"
        )
    if cfg.normalization not in ("per_frame", "cmn", "cmvn"):
        raise ValueError(f"unknown normalization {cfg.normalization!r}")
    fp32_exact()
    signals = torch.as_tensor(signals, dtype=torch.float32)
    dev = signals.device
    hann, dft_cos, dft_sin, mel_fb, dct_m, d1, d2 = _cached_constants(cfg)
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    num_samples = torch.as_tensor(num_samples, device=dev).to(torch.int32)
    n_frames = 1 + torch.div(num_samples, cfg.hop_length, rounding_mode="floor")
    # Zero the padding tail: the last centered frames overlap samples past
    # num_samples, which must read as silence.
    sample_idx = torch.arange(signals.shape[1], device=dev)
    signals = torch.where(sample_idx[None, :] < num_samples[:, None], signals, 0.0)

    power = _power_spectrogram(signals, cfg, (as_t(hann), as_t(dft_cos), as_t(dft_sin)))
    t_total = power.shape[1]
    frame_mask = torch.arange(t_total, device=dev)[None, :] < n_frames[:, None]

    mel_power = power @ as_t(mel_fb).T
    log_mel = _power_to_db(mel_power, frame_mask, cfg)
    mfcc = log_mel @ as_t(dct_m).T

    delta1 = _savgol_interp(mfcc, n_frames, d1, cfg.delta_width)
    delta2 = _savgol_interp(mfcc, n_frames, d2, cfg.delta_width)
    mask = frame_mask[:, :, None]
    if cfg.normalization in ("cmn", "cmvn"):
        raw = torch.cat([mfcc, delta1, delta2], dim=-1)
        count = torch.clamp(n_frames.to(torch.float32), min=1.0)[:, None]
        mean = torch.sum(torch.where(mask, raw, 0.0), dim=1) / count
        feats = raw - mean[:, None, :]
        if cfg.normalization == "cmvn":
            var = torch.sum(torch.where(mask, feats ** 2, 0.0), dim=1) / count
            feats = feats / (torch.sqrt(var)[:, None, :] + cfg.normalize_eps)
    else:
        feats = torch.cat(
            [_normalize_per_frame(mfcc, cfg), delta1, delta2], dim=-1
        )
    feats = torch.where(mask, feats, 0.0)
    return feats, n_frames


def mfcc_features(signal, num_samples=None, cfg: MFCCConfig = MFCCConfig()):
    """(L,) float32 signal -> ((T, 39) features, frame count)."""
    signal = torch.as_tensor(signal, dtype=torch.float32)
    if num_samples is None:
        num_samples = signal.shape[0]
    n = torch.as_tensor([num_samples], device=signal.device)
    feats, n_frames = mfcc_features_batch(signal[None], n, cfg)
    return feats[0], n_frames[0]


def mfcc_batch(signals, sample_rate: float = 16000.0, cfg: MFCCConfig | None = None,
               device=None) -> List[np.ndarray]:
    """A list of 1-D float arrays -> a list of (T_i, 39) float32 arrays, in one
    batch padded to the longest clip, on ``device`` (the CPU by default)."""
    if cfg is None:
        cfg = MFCCConfig(sample_rate=sample_rate)
    if not signals:
        raise ValueError("mfcc_batch: empty clip list")
    lengths = np.array([len(s) for s in signals], np.int32)
    min_frames = 1 + int(lengths.min()) // cfg.hop_length
    if min_frames < cfg.delta_width:
        raise ValueError(
            f"clip with {min_frames} frames is shorter than delta_width="
            f"{cfg.delta_width}; librosa's delta filter rejects such inputs"
        )
    batch = np.zeros((len(signals), int(lengths.max())), np.float32)
    for i, s in enumerate(signals):
        batch[i, : len(s)] = np.asarray(s, np.float32)
    feats, n_frames = mfcc_features_batch(
        torch.as_tensor(batch, device=device),
        torch.as_tensor(lengths, device=device), cfg,
    )
    feats = feats.cpu().numpy()
    n_frames = n_frames.cpu().numpy()
    return [f[:n] for f, n in zip(feats, n_frames)]
