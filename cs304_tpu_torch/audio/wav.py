"""WAV file I/O (scipy read like the reference's loader, stdlib wave writer
like its segmenter — ti_digits.py:130-134, segmentation.py:116-127).
A copy of the JAX package's audio/wav.py."""
from __future__ import annotations

import os
import wave

import numpy as np
import scipy.io.wavfile


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """Returns (sample_rate, float32 signal)."""
    rate, signal = scipy.io.wavfile.read(path)
    return rate, np.asarray(signal, np.float32)


def write_wav_int16(path: str, samples: np.ndarray, sample_rate: int, channels: int = 1) -> None:
    """16-bit PCM writer (reference Segmentation.write_to_wave)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = np.asarray(samples)
    if data.dtype != np.int16:
        data = np.clip(data, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as wav:
        wav.setframerate(int(sample_rate))
        wav.setnchannels(channels)
        wav.setsampwidth(2)
        wav.writeframes(data.tobytes())
