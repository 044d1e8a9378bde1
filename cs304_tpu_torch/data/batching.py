"""Padded batching of ragged sequences (host NumPy), plus the digit vocabulary
and the synthetic benchmark signals the flagship decode is driven with."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

# Label set of the TI-Digits corpus, "O" (oh) and "Z" (zero) included.
DIGIT_LABELS: Tuple[str, ...] = (
    "1", "2", "3", "4", "5", "6", "7", "8", "9", "O", "Z",
)
SAMPLE_RATE = 16000


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class PaddedBatch:
    """data (B, T_pad, D) float32, lengths (B,) int32 true sequence lengths."""

    data: np.ndarray
    lengths: np.ndarray


def pad_batch(
    sequences: Sequence[np.ndarray], length_multiple: int = 128
) -> PaddedBatch:
    """Stack (T_i, D) arrays into (B, T_pad, D), zero-padded, T_pad a
    multiple of ``length_multiple``."""
    lengths = np.array([s.shape[0] for s in sequences], np.int32)
    t_pad = round_up(int(lengths.max()), length_multiple)
    ndim = sequences[0].ndim
    shape = ((len(sequences), t_pad, sequences[0].shape[1]) if ndim > 1
             else (len(sequences), t_pad))
    out = np.zeros(shape, np.float32)
    for i, s in enumerate(sequences):
        out[i, : s.shape[0]] = s
    return PaddedBatch(out, lengths)


def make_signals(batch: int, seconds: float, seed: int = 7) -> np.ndarray:
    """(batch, seconds * 16 kHz) float32 two-tone clips with noise: the
    headline decode benchmark's synthetic audio."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    sigs = []
    for _ in range(batch):
        f0 = rng.uniform(200, 900)
        f1 = rng.uniform(900, 2600)
        sig = (
            np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6))
            + 0.6 * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 6))
        ) * 6000.0
        sig += rng.normal(0, 50.0, n)
        sigs.append(sig.astype(np.float32))
    return np.stack(sigs)
