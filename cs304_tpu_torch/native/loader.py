"""ctypes bindings for the native wavio library, with Python fallbacks.

The library is built and loaded at the first call that needs it, never at
import. ``has_native()`` (the package's ``HAS_NATIVE``, which builds on
first access) says which path the calls take: True for the C++ library,
False for the Python fallbacks, which are the JAX package's documented
twins and give the same results bit for bit.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import numpy as np

from .build import build

logger = logging.getLogger(__name__)

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        logger.warning("failed to load %s: %s", path, e)
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.wav_read.restype = ctypes.c_long
    lib.wav_read.argtypes = [
        ctypes.c_char_p, f32p, ctypes.c_long, ctypes.POINTER(ctypes.c_int)
    ]
    lib.frame_energies.restype = ctypes.c_long
    lib.frame_energies.argtypes = [f32p, ctypes.c_long, ctypes.c_int, f32p]
    lib.endpoint_frames.restype = ctypes.c_long
    lib.endpoint_frames.argtypes = [
        f32p, ctypes.c_long, ctypes.c_float, ctypes.c_float, ctypes.c_int, u8p
    ]
    lib.endpoint_feed.restype = ctypes.c_long
    lib.endpoint_feed.argtypes = [
        i32p, f32p, ctypes.c_long, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, u8p,
    ]
    _lib = lib
    return lib


def has_native() -> bool:
    """True when the C++ library built and loaded (built on first call)."""
    return _load() is not None


def native_read_wav(path: str, max_seconds: float = 120.0) -> Tuple[int, np.ndarray]:
    """(sample_rate, float32 signal); falls back to scipy on any failure."""
    lib = _load()
    if lib is not None:
        max_len = int(max_seconds * 96000)
        out = np.empty(max_len, np.float32)
        rate = ctypes.c_int(0)
        n = lib.wav_read(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_len, ctypes.byref(rate),
        )
        if n >= 0:
            return rate.value, out[:n].copy()
        logger.warning("native wav_read(%s) failed with %d; scipy fallback", path, n)
    import scipy.io.wavfile

    rate_v, signal = scipy.io.wavfile.read(path)
    if signal.ndim > 1:
        signal = signal[:, 0]
    return rate_v, np.asarray(signal, np.float32)


def native_frame_energies(signal: np.ndarray, frame_size: int) -> np.ndarray:
    """Mean |x| per frame, incl. trailing partial frame."""
    signal = np.ascontiguousarray(signal, np.float32)
    n = len(signal)
    n_frames = n // frame_size + (1 if n % frame_size else 0)
    lib = _load()
    if lib is not None and n:
        out = np.empty(max(n_frames, 1), np.float32)
        got = lib.frame_energies(
            signal.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, frame_size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out[:got]
    # Python fallback
    n_full = n // frame_size
    full = np.abs(signal[: n_full * frame_size]).reshape(-1, frame_size).mean(1)
    rem = signal[n_full * frame_size:]
    if len(rem):
        return np.concatenate([full, [np.abs(rem).mean()]]).astype(np.float32)
    return full.astype(np.float32)


def native_endpoint_frames(
    energies: np.ndarray, high: float, low: float, max_silence: int
) -> Tuple[int, np.ndarray]:
    """(done_frame_count or 0, per-frame flags: bit0 result, bit1 noise)."""
    energies = np.ascontiguousarray(energies, np.float32)
    n = len(energies)
    lib = _load()
    if lib is not None:
        labels = np.zeros(max(n, 1), np.uint8)
        done = lib.endpoint_frames(
            energies.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            high, low, max_silence,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        return int(done), labels[:n]
    # Python fallback mirrors wavio.cpp / audio/endpointing.py
    labels = np.zeros(n, np.uint8)
    done, _counter, _between, _ever = _endpoint_py(
        energies, high, low, max_silence, labels, 0, False, False,
        noise_bit=True,
    )
    return done, labels


def _endpoint_py(energies, high, low, max_silence, labels,
                 counter, between, ever, noise_bit):
    """Shared Python hysteresis loop (fallback for both native automata).
    Writes per-frame flags into `labels`; returns (done, counter, between,
    ever) so the stateful streaming caller can carry the machine across
    calls. noise_bit toggles the offline automaton's bit-1 noise flag."""
    done = 0
    for t, e in enumerate(energies):
        fin = False
        lab = 0
        if between:
            if e > low:
                counter = 0
            else:
                between = False
                counter += 1
                fin = counter >= max_silence
        else:
            if e > high:
                between, ever, counter = True, True, 0
            else:
                if noise_bit:
                    lab |= 2
                if ever:
                    counter += 1
                    fin = counter >= max_silence
        if ever:
            lab |= 1
        labels[t] = lab
        if fin:
            done = t + 1
            break
    return done, counter, between, ever


def native_endpoint_feed(
    state: np.ndarray, samples: np.ndarray, frame_size: int,
    high: float, low: float, max_silence: int,
) -> Tuple[int, np.ndarray]:
    """Stateful streaming endpointer over exact full frames (serving hot
    path). `state` is int32[3] {counter, between, ever_high}, updated in
    place and carried across calls. Returns (done_frame_count or 0,
    per-frame bit0 result labels). Frames past an endpoint are NOT consumed
    — re-feed them against a fresh state (mirrors wavio.cpp:endpoint_feed)."""
    samples = np.ascontiguousarray(samples, np.float32)
    n_frames = len(samples) // frame_size
    labels = np.zeros(max(n_frames, 1), np.uint8)
    lib = _load()
    if lib is not None:
        done = lib.endpoint_feed(
            state.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_frames, frame_size, high, low, max_silence,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        return int(done), labels[:n_frames]
    energies = (
        np.abs(samples[: n_frames * frame_size])
        .reshape(-1, frame_size).mean(1)
    )
    done, counter, between, ever = _endpoint_py(
        energies, high, low, max_silence, labels,
        int(state[0]), bool(state[1]), bool(state[2]), noise_bit=False,
    )
    state[0], state[1], state[2] = counter, int(between), int(ever)
    return done, labels[:n_frames]
