"""Streaming MFCC front-end: feed raw samples, emit feature frames online.

The reference front-end is utterance-global in exactly one place that matters:
`power_to_db(ref=np.max)` normalizes against the WHOLE utterance's peak mel
power (mfcc.py:35) — unknowable online. This streamer takes an explicit
`ref_power` (from mic calibration or the endpointer's peak estimate) instead;
when `ref_power` equals the true utterance max, the emitted frames match the
offline features exactly. The other stages are already causal or finitely
latent: framing/DFT/mel/DCT are per-frame, the per-frame coefficient
normalization (the reference's quirk) has no time dependence, and the
Savitzky-Golay deltas need ±4 frames of context — so frames are emitted with a
4-frame delay and `finalize()` flushes the tail with the offline 'interp'
edge handling.

Together with ops.streaming.StreamingComposite this closes the loop:
samples -> features -> partial hypotheses, all online.

A copy of the JAX package's ops/streaming_mfcc.py: host NumPy, on the
constants of this package's ops/mfcc.py (the same 7-tuple).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np

from .mfcc import MFCCConfig, _cached_constants


class StreamingMFCC:
    """Online 39-dim feature extraction with a fixed dB reference.

    >>> sm = StreamingMFCC(ref_power=calibrated_peak)
    >>> for chunk in mic:                    # arbitrary-size sample chunks
    ...     feats = sm.feed(chunk)            # (k, 39) newly finalized frames
    >>> feats_tail = sm.finalize()            # last frames with edge handling
    """

    def __init__(
        self, cfg: MFCCConfig = MFCCConfig(), ref_power: float = 1.0
    ) -> None:
        if cfg.normalization != "per_frame":
            # CMVN needs whole-utterance statistics — unknowable online.
            # Decode streams against per_frame-trained checkpoints only.
            raise ValueError(
                "StreamingMFCC supports normalization='per_frame' only; "
                f"got {cfg.normalization!r} (CMVN is utterance-global)"
            )
        self.cfg = cfg
        self.ref_power = float(ref_power)
        _hann, dft_cos, dft_sin, mel_fb, dct_m, d1, d2 = _cached_constants(cfg)
        self._dft_cos = np.asarray(dft_cos)
        self._dft_sin = np.asarray(dft_sin)
        self._mel_fb = np.asarray(mel_fb)
        self._dct_m = np.asarray(dct_m)
        self._d1 = d1
        self._d2 = d2
        self._half = cfg.delta_width // 2
        self.reset()

    def reset(self) -> None:
        hop = self.cfg.hop_length
        # Center padding: the first frame is centered at sample 0.
        self._buffer = np.zeros(hop, np.float32)  # leading zero block
        # Raw (un-normalized) mfcc history: a doubling (cap, 13) array —
        # the serving host loop feeds hundreds of sessions per round, and
        # the original one-python-call-per-frame list was the measured
        # per-session cost pinning partials capacity (round 5).
        self._mfcc_arr = np.zeros((64, self.cfg.n_mfcc), np.float32)
        self._n = 0
        self._emitted = 0
        self.last_feed_mel_peak = 0.0

    @property
    def _mfcc(self) -> np.ndarray:
        return self._mfcc_arr[: self._n]

    def _append_mfcc(self, rows: np.ndarray) -> None:
        need = self._n + len(rows)
        if need > len(self._mfcc_arr):
            cap = len(self._mfcc_arr)
            while cap < need:
                cap *= 2
            grown = np.zeros((cap, self.cfg.n_mfcc), np.float32)
            grown[: self._n] = self._mfcc_arr[: self._n]
            self._mfcc_arr = grown
        self._mfcc_arr[self._n : need] = rows
        self._n = need

    # -- internals -----------------------------------------------------------
    def _mfcc_frames(self, frames: np.ndarray) -> np.ndarray:
        """(k, n_fft) windowed-DFT/mel/dB/DCT — one vectorized pass.

        float64 accumulation: batched f32 BLAS rounds differently per batch
        size, which broke chunking invariance (feeding the same audio in 1
        vs 30 chunks must emit identical frames); at f64 the batch-order
        difference is ~1e-15, invisible after the final f32 cast."""
        frames = frames.astype(np.float64)
        re = frames @ self._dft_cos
        im = frames @ self._dft_sin
        power = re * re + im * im
        mel = power @ self._mel_fb.T
        # Free byproduct for the serving recalibration check: the peak mel
        # power of the frames just processed (a separate per-chunk mel_peak
        # pass on the raw samples was ~0.25 ms/session/round of host work).
        if mel.size:
            self.last_feed_mel_peak = max(
                self.last_feed_mel_peak, float(mel.max())
            )
        amin = self.cfg.amin
        db = 10 * np.log10(np.maximum(amin, mel)) - 10 * np.log10(
            np.maximum(amin, self.ref_power)
        )
        # Online top_db clamp uses the fixed reference (= the peak when
        # calibrated), i.e. max(db, -top_db).
        db = np.maximum(db, -self.cfg.top_db)
        return (db @ self._dct_m.T).astype(np.float32)

    def _features_for(self, idx: int, tail: bool = False) -> np.ndarray:
        """Assemble the 39-dim vector for frame idx (requires idx+4 frames,
        or tail=True for edge handling)."""
        w = self.cfg.delta_width
        interior1, el1, er1 = self._d1
        interior2, el2, er2 = self._d2
        n = self._n

        # Slice only the <= w frames each window needs: touching the WHOLE
        # history here made long utterances quadratic (profiled dominant in
        # the serving host loop at 1024 sessions).
        def window_of(lo, hi):
            return self._mfcc[lo:hi]

        def delta(ops_interior, edge_left, edge_right, i):
            if i < self._half:
                window = window_of(0, w)
                if len(window) < w:  # ultra-short utterance: pad by repeat
                    window = np.pad(window, ((0, w - len(window)), (0, 0)), "edge")
                return edge_left[i] @ window
            if tail and i >= n - self._half:
                window = window_of(max(n - w, 0), n)
                if len(window) < w:
                    window = np.pad(window, ((w - len(window), 0), (0, 0)), "edge")
                return edge_right[i - (n - self._half)] @ window
            return ops_interior @ window_of(i - self._half, i + self._half + 1)

        mfcc = self._mfcc[idx]
        mean = mfcc.mean()
        std = mfcc.std()
        norm = (mfcc - mean) / (std + self.cfg.normalize_eps)
        d1 = delta(interior1, el1, er1, idx)
        d2 = delta(interior2, el2, er2, idx)
        return np.concatenate([norm, d1, d2]).astype(np.float32)

    def _extract_frames(self) -> None:
        """Consume all complete n_fft windows from the sample buffer in one
        vectorized pass (stride view + one batched matmul chain)."""
        hop, n_fft = self.cfg.hop_length, self.cfg.n_fft
        buf = self._buffer
        if len(buf) < n_fft:
            return
        k = (len(buf) - n_fft) // hop + 1
        frames = np.lib.stride_tricks.sliding_window_view(
            buf, n_fft
        )[:: hop][:k]
        self._append_mfcc(self._mfcc_frames(frames))
        self._buffer = buf[k * hop:].copy()

    def _emit_range(self, e0: int, e1: int) -> np.ndarray:
        """Assemble feature rows for frames [e0, e1) — all interior/left-edge
        (feed-time) frames in one vectorized pass. Requires e1 + half <= n."""
        w, half = self.cfg.delta_width, self._half
        interior1, el1, er1 = self._d1
        interior2, el2, er2 = self._d2
        m = self._mfcc[e0:e1]  # (k, 13)
        mean = m.mean(axis=1, keepdims=True)
        std = m.std(axis=1, keepdims=True)
        norm = (m - mean) / (std + self.cfg.normalize_eps)
        k = e1 - e0
        d1 = np.empty((k, m.shape[1]), np.float32)
        d2 = np.empty((k, m.shape[1]), np.float32)
        # Left edge (frame index < half): fixed first window.
        n_edge = max(0, min(half - e0, k))
        if n_edge:
            first = self._mfcc[:w]
            d1[:n_edge] = el1[e0 : e0 + n_edge] @ first
            d2[:n_edge] = el2[e0 : e0 + n_edge] @ first
        if n_edge < k:
            i0 = e0 + n_edge  # first interior frame index
            windows = np.lib.stride_tricks.sliding_window_view(
                self._mfcc[i0 - half : e1 + half], w, axis=0
            )  # (k - n_edge, 13, w)
            d1[n_edge:] = np.einsum("w,kcw->kc", interior1, windows)
            d2[n_edge:] = np.einsum("w,kcw->kc", interior2, windows)
        return np.concatenate([norm, d1, d2], axis=1).astype(np.float32)

    # -- public ---------------------------------------------------------------
    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Feed raw samples; returns newly available (k, 39) frames (frames
        are released once 4 future frames exist). After the call,
        `last_feed_mel_peak` holds the peak mel power seen in THIS call's
        processed frames (0.0 when no frame completed)."""
        self.last_feed_mel_peak = 0.0
        self._buffer = np.concatenate(
            [self._buffer, np.asarray(samples, np.float32)]
        )
        self._extract_frames()
        # Frame i needs frames up to i+half for its deltas (4-frame latency);
        # left-edge frames additionally need a full first window.
        if self._n < self.cfg.delta_width:
            return np.zeros((0, 3 * self.cfg.n_mfcc), np.float32)
        e0, e1 = self._emitted, self._n - self._half
        if e1 <= e0:
            return np.zeros((0, 3 * self.cfg.n_mfcc), np.float32)
        out = self._emit_range(e0, e1)
        self._emitted = e1
        return out

    def finalize(self) -> np.ndarray:
        """Flush remaining frames with the offline right-edge handling.
        Matches offline features when ref_power equals the utterance's true
        mel-power max."""
        # Trailing center pad (the offline STFT pads n_fft//2 zeros at the
        # end too): flushes the final frame(s).
        pad = self.cfg.n_fft - self.cfg.hop_length
        self._buffer = np.concatenate([self._buffer, np.zeros(pad, np.float32)])
        self._extract_frames()
        out = []
        n = self._n
        while self._emitted < n:
            out.append(self._features_for(self._emitted, tail=True))
            self._emitted += 1
        return np.stack(out) if out else np.zeros((0, 3 * self.cfg.n_mfcc), np.float32)


def mel_peak(samples: np.ndarray, cfg: MFCCConfig = MFCCConfig()) -> float:
    """Peak mel power of the given samples — the dB reference calibrator.

    When this equals the true utterance-wide peak, StreamingMFCC's frames
    match the offline front-end exactly (power_to_db ref=max); a live system
    calibrates from mic setup or the first speech frames instead. The
    framing/window/filterbank conventions here must stay identical to the
    offline pipeline's (ops/mfcc.py) — the one shared implementation is the
    point (it had been duplicated in two demo scripts and the serving layer).
    """
    sig = np.asarray(samples, np.float64)
    n_fft, hop = cfg.n_fft, cfg.hop_length
    padded = np.pad(sig, (n_fft // 2, n_fft // 2))
    window, fb = _mel_peak_constants(
        cfg.sample_rate, n_fft, cfg.n_mels, cfg.fmin, cfg.fmax
    )
    n_frames = min(1 + len(sig) // hop,
                   max(0, (len(padded) - n_fft) // hop + 1))
    if n_frames <= 0:
        return 1e-10
    frames = np.lib.stride_tricks.sliding_window_view(
        padded, n_fft
    )[:: hop][:n_frames]
    # One batched rfft instead of a per-frame Python loop — this runs per
    # serving session per chunk (calibration + recalibration checks).
    p = np.abs(np.fft.rfft(frames * window, axis=1)) ** 2
    return max(1e-10, float((p @ fb.T).max()))


@lru_cache(maxsize=8)
def _mel_peak_constants(sr: float, n_fft: int, n_mels: int,
                        fmin: float, fmax: float):
    """Window + filterbank for mel_peak — cached: serving calls mel_peak per
    session per chunk and rebuilding the filterbank dominated its cost."""
    from .mfcc import mel_filterbank

    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    fb = np.asarray(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))
    return window, fb
