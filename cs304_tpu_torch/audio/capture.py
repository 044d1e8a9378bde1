"""Live microphone capture with energy-based endpointing (press-to-talk).

A copy of the JAX package's audio/capture.py (host NumPy; the streaming
endpointer is the native tier's endpoint_feed). Kept apart from
audio/endpointing.py, the offline separator, as the JAX package keeps them.

Re-implements the reference's Segmentation stack (segmentation.py:17-250):
a PortAudio callback feeding a thread-safe queue, per-320-sample-frame energy
gating with high/low hysteresis thresholds, a weighted-history noise-floor
estimator, a silence-duration counter that ends the take, and a 16-bit WAV
writer for the captured segment.

sounddevice is optional (it is not installed in CI): importing this module
works everywhere; constructing a live Segmentation without sounddevice raises
a clear error. The state machine itself is injectable — tests drive it with a
plain queue of synthetic frames (`Segmentation(stream=None, ...)` + `routine`).
"""
from __future__ import annotations

import logging
import os
import queue
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .wav import write_wav_int16
from ..native import native_endpoint_feed as _endpoint_feed

logger = logging.getLogger(__name__)

try:  # pragma: no cover - environment dependent
    import sounddevice as sd

    HAS_SOUNDDEVICE = True
except Exception:  # ModuleNotFoundError or PortAudio load failure
    sd = None
    HAS_SOUNDDEVICE = False


@dataclass
class NoiseFloor:
    """Weighted average of recent background-sample energies
    (reference segmentation.py:17-52, recency-weighted)."""

    num_of_samples: int = 5
    _history: List[np.ndarray] = field(default_factory=list)
    _noise_floor: float = 0.0

    def update(self, samples: np.ndarray) -> float:
        self._history.append(np.asarray(samples))
        if len(self._history) > self.num_of_samples:
            self._history.pop(0)
        total, weight = 0.0, 0
        for index, s in enumerate(reversed(self._history)):
            w = self.num_of_samples - index
            weight += w
            total += w * float(np.mean(np.abs(s))) if len(s) else 0.0
        self._noise_floor = total / weight if weight else 0.0
        return self._noise_floor

    @property
    def noise_floor(self) -> float:
        return self._noise_floor


class SegmentationDone(Exception):
    """Raised internally when enough trailing silence has accumulated."""


@dataclass
class SpeechEndCounter:
    """Counts consecutive no-speech frames (reference segmentation.py:58-81)."""

    frame_count_threshold: int
    _counter: int = 0

    def no_speech(self) -> None:
        self._counter += 1
        if self._counter >= self.frame_count_threshold:
            raise SegmentationDone

    def has_speech(self) -> None:
        self._counter = 0

    @property
    def count(self) -> int:
        return self._counter


@dataclass
class Segmentation:
    """Hit-to-talk capture loop (reference segmentation.py:84-250).

    `stream` may be None for offline/testing use: feed frames through
    `audio_cache` and call `routine()` directly.
    """

    stream: Optional[object] = None
    audio_cache: "queue.Queue" = field(default_factory=queue.Queue)
    save_path: str = "./segment_results"

    frame_size: int = 320
    speech_high_threshold: float = 512.0
    speech_low_threshold: float = 64.0
    silence_duration_threshold: float = 0.1
    sample_rate: int = 16000

    _noise_floor: NoiseFloor = field(default_factory=NoiseFloor)
    _between: bool = False
    _ever_high: bool = False
    _results: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self) -> None:
        per_frame_time = self.frame_size / self.sample_rate
        self._max_silence_frames = max(
            int(self.silence_duration_threshold / per_frame_time), 1
        )
        self._end_counter = SpeechEndCounter(self._max_silence_frames)
        # Reused (counter, between, ever_high) buffer for feed_frames — a
        # fresh np.array per 100 ms chunk was a measurable share of the
        # serving host loop.
        self._feed_state = np.zeros(3, np.int32)

    # -- frame-level state machine (identical to the offline separator) -----
    def detect_speech(self, frame: np.ndarray, threshold: str) -> bool:
        energy = float(np.mean(np.abs(frame))) if len(frame) else 0.0
        limit = (
            self.speech_high_threshold if threshold == "high" else self.speech_low_threshold
        )
        return energy > limit

    def routine(self) -> None:
        """Drain the queue and run the hysteresis machine over its frames.
        Raises SegmentationDone when the take ends (reference :154-197)."""
        audio = self.get_all_frames_from_queue(self.audio_cache)
        n_full = len(audio) // self.frame_size
        frames = list(audio[: n_full * self.frame_size].reshape(-1, self.frame_size))
        tail = audio[n_full * self.frame_size :]
        if len(tail):
            frames.append(tail)
        for frame in frames:
            if self._between:
                if self.detect_speech(frame, "low"):
                    self._end_counter.has_speech()
                else:
                    self._between = False
                    self._append_and_check(frame)
                    continue
            else:
                if self.detect_speech(frame, "high"):
                    self._between = True
                    self._ever_high = True
                    self._end_counter.has_speech()
                elif self._ever_high:
                    self._append_and_check(frame)
                    continue
            if self._ever_high:
                self._results.append(frame)

    def feed_frames(self, samples: np.ndarray) -> tuple:
        """Batched streaming advance over EXACT full frames — the serving
        hot path. One native call (cs304_tpu_torch/native wavio.cpp:endpoint_feed;
        Python fallback identical) fuses the per-frame energies with the
        hysteresis machine instead of paying the queue/`routine()`/exception
        round-trip per 20 ms frame. Returns (done, consumed_samples): when
        `done`, the take ended after `consumed_samples` — re-feed the
        remainder to a fresh Segmentation (nothing between utterances is
        lost). State stays in the same attributes routine() uses, so the two
        entry points can interleave."""
        samples = np.ascontiguousarray(samples, np.float32).reshape(-1)
        n_frames = len(samples) // self.frame_size
        if n_frames * self.frame_size != len(samples):
            raise ValueError(
                f"feed_frames needs whole {self.frame_size}-sample frames; "
                f"got {len(samples)} samples"
            )
        if not n_frames:
            return False, 0
        state = self._feed_state
        state[0] = self._end_counter._counter
        state[1] = self._between
        state[2] = self._ever_high
        done, labels = _endpoint_feed(
            state, samples, self.frame_size,
            self.speech_high_threshold, self.speech_low_threshold,
            self._max_silence_frames,
        )
        self._end_counter._counter = int(state[0])
        self._between = bool(state[1])
        self._ever_high = bool(state[2])
        upto = done if done else n_frames
        if labels[upto - 1]:
            # ever_high latches, so labels are 0...0 1...1 within a call:
            # everything from the first 1 belongs to the result. Copy the
            # retained region — ascontiguousarray above is a no-op for
            # contiguous float32 input, so slices would otherwise be views
            # into the caller's (reusable) feed buffer.
            start = int(labels[:upto].argmax())
            frames = samples[
                start * self.frame_size : upto * self.frame_size
            ].copy().reshape(-1, self.frame_size)
            self._results.extend(frames)
        return bool(done), upto * self.frame_size

    def _append_and_check(self, frame: np.ndarray) -> None:
        # Record the frame first so the trailing-silence trim below stays
        # aligned, then count it (which may raise SegmentationDone).
        if self._ever_high:
            self._results.append(frame)
        self._end_counter.no_speech()

    def result_signal(self) -> np.ndarray:
        """Captured samples minus the trailing silence frames
        (reference :147-149)."""
        if not self._results:
            return np.zeros(0, np.float32)
        keep = self._results[: -self._end_counter.frame_count_threshold] or self._results
        return np.concatenate([np.asarray(f).reshape(-1) for f in keep])

    def initialize_noise_floor(self) -> None:
        samples = self.get_all_frames_from_queue(self.audio_cache, block=False)
        if len(samples):
            self._noise_floor.update(samples)
        logger.info("noise floor initialized to %.1f", self._noise_floor.noise_floor)

    # -- live loop ----------------------------------------------------------
    def main(self) -> Optional[str]:
        """Blocking press-to-talk capture; writes segment_results/result.wav
        (reference :129-152). Requires sounddevice."""
        if self.stream is None:
            raise RuntimeError(
                "live capture requires sounddevice (not installed); use "
                "routine() with an injected audio_cache for offline frames"
            )
        per_frame_time = self.frame_size / self.sample_rate
        try:
            with self.stream:
                input("Press enter to start recording")
                self._ever_high = False
                self.initialize_noise_floor()
                print("Recording started")
                while True:
                    time.sleep(self.silence_duration_threshold + per_frame_time)
                    self.routine()
        except (KeyboardInterrupt, SegmentationDone):
            print("\nGracefully exiting")
        signal = self.result_signal()
        if not len(signal):
            logger.warning("no results from segmentation")
            return None
        path = os.path.join(self.save_path, "result.wav")
        write_wav_int16(path, signal, self.sample_rate)
        return path

    @staticmethod
    def get_all_frames_from_queue(cache: "queue.Queue", block: bool = True) -> np.ndarray:
        chunks = []
        try:
            if block:
                chunks.append(np.asarray(cache.get(timeout=5.0)).reshape(-1))
            while True:
                chunks.append(np.asarray(cache.get_nowait()).reshape(-1))
        except queue.Empty:
            pass
        if not chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(chunks)

    @classmethod
    def from_basic(
        cls,
        sample_rate: int = 16000,
        channels: List[int] = [1],
        save_path: str = "./segment_results",
        **kwargs,
    ) -> "Segmentation":
        """Build a live capture session (reference :229-250)."""
        if not HAS_SOUNDDEVICE:
            raise RuntimeError(
                "sounddevice is not available in this environment; "
                "install it for live microphone capture"
            )
        audio_cache: queue.Queue = queue.Queue()
        mapping = [c - 1 for c in channels]

        def audio_callback(indata, frames, time_info, status):
            if status:
                logger.warning("audio status: %s", status)
            audio_cache.put(indata[::1, mapping])

        stream = sd.InputStream(
            channels=max(channels),
            samplerate=sample_rate,
            callback=audio_callback,
            dtype=np.int16,
        )
        return cls(
            stream=stream,
            audio_cache=audio_cache,
            save_path=save_path,
            sample_rate=sample_rate,
            **kwargs,
        )
