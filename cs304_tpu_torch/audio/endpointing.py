"""Offline energy-based endpointing (silence removal + noise harvesting).

A copy of cs304_tpu/audio/endpointing.py, numpy only: the frame energies and
the hysteresis automaton are that package's pure-Python fallbacks
(cs304_tpu/native/loader.py), which its C++ tier matches byte for byte.

Re-implements the reference's SignalSeparation (signal_separation.py:44-165):
per-frame mean |amplitude| energies gated by a high/low hysteresis state
machine with thresholds relative to the clip's max volume (:71-76), a
silence-duration counter that ends the segment, collection of the non-speech
frames as noise clips for silence-model training (:139-151), and rejection of
results shorter than 9 frames (the MFCC delta width, :95-97).

Divergence from the reference (documented): the reference leaks `_noise`
accumulation across failed clips (it only resets on success,
signal_separation.py:92-94); here noise state is reset per clip.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class FailToProcess(RuntimeError):
    """Clip could not be segmented (never ended, or result too short)."""


def frame_energies(signal: np.ndarray, frame_size: int) -> np.ndarray:
    """Mean |x| per frame, incl. the trailing partial frame."""
    signal = np.ascontiguousarray(signal, np.float32)
    n_full = len(signal) // frame_size
    full = np.abs(signal[: n_full * frame_size]).reshape(-1, frame_size).mean(1)
    rem = signal[n_full * frame_size:]
    if len(rem):
        return np.concatenate([full, [np.abs(rem).mean()]]).astype(np.float32)
    return full.astype(np.float32)


def endpoint_frames(
    energies: np.ndarray, high: float, low: float, max_silence: int
) -> Tuple[int, np.ndarray]:
    """Hysteresis automaton over frame energies -> (done_frame_count or 0,
    per-frame flags: bit0 result, bit1 noise)."""
    labels = np.zeros(len(energies), np.uint8)
    done, counter, between, ever = 0, 0, False, False
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
    return done, labels


@dataclass
class SignalSeparation:
    sample_rate: int = 16000
    frame_time: float = 0.01
    speech_high_threshold: float = 0.08  # fraction of clip max volume
    speech_low_threshold: float = 0.01
    silence_duration_threshold: float = 0.02  # seconds

    _noises: List[np.ndarray] = field(default_factory=list)

    @property
    def frame_size(self) -> int:
        return int(self.sample_rate * self.frame_time)

    @property
    def maximum_silence_frames(self) -> int:
        return int(self.silence_duration_threshold / self.frame_time)

    def _segment(self, signal: np.ndarray) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """Run the hysteresis state machine over one clip.

        The reference iterates full frames plus an ALWAYS appended (possibly
        empty) tail frame (signal_separation.py:104-110); the empty tail
        counts as an energy-0 frame, which we reproduce.

        Returns (speech or None, noise). None means segmentation never
        completed (no trailing silence long enough).
        """
        signal = np.asarray(signal, np.float32)
        max_volume = float(np.max(np.abs(signal))) if len(signal) else 0.0
        high = self.speech_high_threshold * max_volume
        low = self.speech_low_threshold * max_volume
        fs = self.frame_size

        energies = frame_energies(signal, fs)
        if len(signal) % fs == 0:
            # The reference's frame iterator always appends the (empty) tail.
            energies = np.concatenate([energies, [np.float32(0.0)]])
        done, labels = endpoint_frames(
            energies, high, low, self.maximum_silence_frames
        )

        # Map frame indices back to sample spans (the extra tail frame is empty).
        def frames_signal(mask: np.ndarray) -> np.ndarray:
            idx = np.where(mask)[0]
            if len(idx) == 0:
                return np.zeros(0, np.float32)
            pieces = [signal[t * fs : min((t + 1) * fs, len(signal))] for t in idx]
            return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)

        upto = done if done else len(labels)
        flags = labels[:upto]
        noise_sig = frames_signal((flags & 2) > 0)
        if not done:
            return None, noise_sig
        return frames_signal((flags & 1) > 0), noise_sig

    def remove_empty(self, signal: np.ndarray) -> np.ndarray:
        """Strip leading/trailing silence from one clip; harvest its noise.

        Raises FailToProcess like the reference (:88-100) when segmentation
        never completes or the result is shorter than 9 frames.
        """
        speech, noise = self._segment(signal)
        if speech is None:
            raise FailToProcess("segmentation never completed")
        if len(noise):
            self._noises.append(noise)
        if len(speech) < 9 * self.frame_size:
            raise FailToProcess(f"result too short: {len(speech)} samples")
        return speech

    def remove_empty_batch(self, signals) -> List[np.ndarray]:
        """Silence-strip a clip list, skipping failures with a warning
        (reference :78-86)."""
        results = []
        for signal in signals:
            try:
                results.append(self.remove_empty(signal))
            except FailToProcess as e:
                logger.warning(
                    "skipping clip (len %d, max %.1f): %s",
                    len(signal), float(np.max(np.abs(signal))) if len(signal) else 0.0, e,
                )
        return results

    def get_all_noises(self) -> List[np.ndarray]:
        return list(self._noises)
