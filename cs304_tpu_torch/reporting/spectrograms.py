"""Signal-analysis visualizations: spectrogram, mel spectrogram, MFCC heatmap,
cepstrum.

Capability parity with the reference's deprecated visualization tier
(deprecated/visualization.py:40-203 — hand-rolled framing+window+FFT
spectrograms and cepstra; deprecated/visualization_librosa.py:35-105 —
spectrogram/mel/MFCC plots). The arrays come from the same front-end math as
ops/mfcc (so what you plot is exactly what the recognizer sees); matplotlib is
imported lazily. The spectrograms are NumPy; the MFCC heatmap runs the
port's front end on ``device`` (the card by default, ``device="cpu"`` for
the CPU).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops.mfcc import MFCCConfig, mel_filterbank, mfcc_features


def power_spectrogram_db(signal: np.ndarray, cfg: MFCCConfig = MFCCConfig()):
    """(T, bins) dB power spectrogram, same framing/window as the front-end."""
    sig = np.asarray(signal, np.float64)
    hop, n_fft = cfg.hop_length, cfg.n_fft
    pad = n_fft // 2
    padded = np.pad(sig, (pad, pad))
    t_frames = 1 + len(sig) // hop
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    frames = np.stack(
        [padded[t * hop : t * hop + n_fft] * window for t in range(t_frames)]
    )
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    db = 10 * np.log10(np.maximum(cfg.amin, power))
    return db - db.max()


def mel_spectrogram_db(signal: np.ndarray, cfg: MFCCConfig = MFCCConfig()):
    """(T, n_mels) dB mel spectrogram (Slaney filterbank)."""
    db = power_spectrogram_db(signal, cfg)
    power = 10 ** ((db + 0.0) / 10)
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    mel = power @ fb.T
    out = 10 * np.log10(np.maximum(cfg.amin, mel))
    return out - out.max()


def cepstrum(signal: np.ndarray, cfg: MFCCConfig = MFCCConfig()):
    """(T, n_fft//2+1) real cepstrum per frame (the deprecated tier's
    from-first-principles cepstrogram, deprecated/visualization.py:150-203)."""
    db = power_spectrogram_db(signal, cfg)
    log_power = db / 10.0  # log10 units; scale does not change the structure
    ceps = np.fft.irfft(log_power, axis=-1)
    return ceps[:, : db.shape[1]]


def mfcc_heatmap_data(signal: np.ndarray, cfg: MFCCConfig = MFCCConfig(),
                      device=None):
    """(T, 39) front-end features exactly as decoded."""
    x = torch.as_tensor(np.asarray(signal, np.float32), device=resolve_device(device))
    feats, t_valid = mfcc_features(x, cfg=cfg)
    return feats.cpu().numpy()[: int(t_valid)]


def _save_heatmap(data, title, ylabel, out_dir, sample_rate, hop) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 4))
    extent = [0, data.shape[0] * hop / sample_rate, 0, data.shape[1]]
    plt.imshow(data.T, aspect="auto", origin="lower", extent=extent)
    plt.colorbar()
    plt.title(title)
    plt.xlabel("time (s)")
    plt.ylabel(ylabel)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{title.replace(' ', '_')}.png")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return path


def plot_spectrogram(signal, title="spectrogram", out_dir="./plots",
                     cfg: MFCCConfig = MFCCConfig()) -> str:
    return _save_heatmap(power_spectrogram_db(signal, cfg), title, "FFT bin",
                         out_dir, cfg.sample_rate, cfg.hop_length)


def plot_mel_spectrogram(signal, title="mel_spectrogram", out_dir="./plots",
                         cfg: MFCCConfig = MFCCConfig()) -> str:
    return _save_heatmap(mel_spectrogram_db(signal, cfg), title, "mel band",
                         out_dir, cfg.sample_rate, cfg.hop_length)


def plot_mfcc(signal, title="mfcc_features", out_dir="./plots",
              cfg: MFCCConfig = MFCCConfig(), device=None) -> str:
    return _save_heatmap(mfcc_heatmap_data(signal, cfg, device=device), title,
                         "coefficient (13 mfcc + 13 d + 13 dd)",
                         out_dir, cfg.sample_rate, cfg.hop_length)
