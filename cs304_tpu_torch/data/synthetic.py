"""Synthetic TI-Digits-style corpus for tests and benchmarks (a copy of
cs304_tpu/data/synthetic.py: numpy and scipy only).

The reference validates multi-digit decoding on audio fabricated by
concatenating single-digit clips (DataLoader.get_combined, reference
ti_digits.py:70-77, used by scripts/project4_phone.py:29). This module extends
that fixture idea into a full generated corpus: each digit is a short
formant-like phone sequence with per-speaker and per-take variability, so the
entire train -> decode -> accuracy pipeline can run (and be gated) without the
licensed TI-Digits data.

The acoustics are deliberately simple but non-trivial: every digit has a
3-phone template of (f1, f2) formant pairs; speakers scale formants, speaking
rate, and amplitude; takes add jitter and noise. HMM/MFCC systems reach high
accuracy only if alignment, training, and decoding all work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from .ti_digits import DataLoader

SAMPLE_RATE = 16000

# Per-digit 3-phone templates: ((f1, f2), ...) in Hz. Chosen to be mutually
# distinguishable but with deliberate overlaps (e.g. "1"/"9" share a phone)
# so the task is not linearly separable from a single frame.
_DIGIT_PHONES: Dict[str, tuple] = {
    "1": ((300, 2200), (700, 1200), (450, 1700)),
    "2": ((500, 1500), (900, 2400), (350, 900)),
    "3": ((650, 1900), (400, 2600), (800, 1400)),
    "4": ((350, 1100), (600, 2000), (950, 2500)),
    "5": ((750, 2300), (500, 800), (300, 1500)),
    "6": ((400, 2500), (850, 1800), (550, 1000)),
    "7": ((900, 1300), (300, 2100), (700, 2400)),
    "8": ((550, 1700), (750, 2600), (400, 1200)),
    "9": ((300, 2200), (950, 1600), (600, 2300)),
    "O": ((450, 900), (650, 1100), (850, 1600)),
    "Z": ((800, 2600), (350, 1400), (500, 2200)),
}


def join_transcript(words: Sequence[str]):
    """Canonical corpus key for a word sequence: the concatenated string when
    every label is one character (the reference's digit-string transcripts,
    e.g. "4Z2Z1"), else the tuple of labels (multi-char vocabularies — a
    joined string would be ambiguous to split back into words)."""
    words = tuple(str(w) for w in words)
    if all(len(w) == 1 for w in words):
        return "".join(words)
    return words


def transcript_seed_key(transcript) -> bytes:
    """Deterministic bytes for seeding RNGs from a str-or-tuple transcript."""
    if isinstance(transcript, str):
        return transcript.encode()
    return "|".join(transcript).encode()


@dataclass
class SyntheticTIDigits:
    """Generated corpus with the same surface as data.ti_digits.TIDigits.

    Difficulty knobs (all default to the easy legacy corpus; use ``hard()``
    for a calibrated non-saturating benchmark corpus):

    - ``snr_db``: per-utterance additive white noise at an SNR drawn uniformly
      from this (lo, hi) range, measured against the speech RMS. None keeps
      the legacy near-clean recordings.
    - ``channel_filter``: per-speaker spectral coloration (a random one-pole
      tilt + a mild resonance), simulating microphone/channel variation
      between speakers.
    - ``formant_scale_range`` / ``rate_range``: speaker variability spread.
    - ``formant_jitter``: per-phone relative formant deviation per take;
      larger values blur the templates into each other (confusability).
    """

    num_train_speakers: int = 8
    num_test_speakers: int = 4
    takes_per_digit: int = 3
    seed: int = 1234
    # Also generate multi-digit utterances into both splits (labels are the
    # transcripts), mirroring real TI-Digits' mixed-length recordings.
    with_sentences: bool = False
    sentence_lengths: tuple = (2, 4, 7)
    sentences_per_length: int = 4
    # Difficulty knobs. snr_db applies to multi-digit sentences (the decode
    # path); snr_db_isolated applies to isolated digit clips (the training
    # path, which runs through energy endpointing whose max-relative low
    # threshold of 1% needs >~30 dB SNR to ever see trailing silence —
    # matching real TI-Digits' quiet-booth recordings).
    snr_db: tuple | None = None
    snr_db_isolated: tuple | None = None
    channel_filter: bool = False
    formant_scale_range: tuple = (0.93, 1.08)
    rate_range: tuple = (0.85, 1.2)
    formant_jitter: float = 0.015
    # Vocabulary: label -> ((f1, f2), ...) phone templates. None = the 11
    # TI-Digits labels above; the JAX package's data/wordvocab.py generates
    # 100+-word inventories
    # (multi-char labels, tuple transcripts) through this same knob.
    phone_templates: Dict[str, tuple] | None = None
    # Left-context coarticulation: fraction of each phone's onset over which
    # its formants GLIDE from the previous phone's realized formants (real
    # speech transitions; 0.0 = the legacy piecewise-constant synthesis,
    # bit-identical to prior corpora). Word-initial phones start at their
    # own targets (silence carries no formants), matching the biphone
    # tier's silence-context convention (models/biphone.py).
    coarticulation: float = 0.0
    # Anticipatory (right-context) coarticulation: fraction of each phone's
    # OFFSET that glides toward the NEXT phone's target formants — the cue
    # only triphones can model (models/triphone.py); left-context units
    # share one model across successors. Word-final phones hold their
    # targets. 0.0 = no anticipation (bit-identical to prior corpora).
    anticipatory_coarticulation: float = 0.0

    @classmethod
    def hard(cls, **overrides) -> "SyntheticTIDigits":
        """Calibrated hardened corpus: realistic SNR, channel coloration,
        wide speaker spread, and confusable templates, tuned so the trained
        reference pipeline lands below saturation on held-out speakers
        (the 85% regime of the reference's README.md:9) instead of the
        trivially-100% legacy corpus."""
        defaults = dict(
            snr_db=(10.0, 20.0),
            snr_db_isolated=(30.0, 40.0),
            channel_filter=True,
            formant_scale_range=(0.82, 1.22),
            rate_range=(0.65, 1.45),
            formant_jitter=0.055,
        )
        defaults.update(overrides)
        return cls(**defaults)

    @property
    def labels(self) -> List[str]:
        return list(self.phone_templates or _DIGIT_PHONES)

    def __post_init__(self) -> None:
        if not 0.0 <= self.coarticulation <= 1.0:
            raise ValueError(
                f"coarticulation must be in [0, 1] (fraction of each "
                f"phone's onset), got {self.coarticulation}"
            )
        if not 0.0 <= self.anticipatory_coarticulation <= 1.0:
            raise ValueError(
                f"anticipatory_coarticulation must be in [0, 1] (fraction "
                f"of each phone's offset), got "
                f"{self.anticipatory_coarticulation}"
            )
        if self.coarticulation + self.anticipatory_coarticulation > 1.0:
            raise ValueError(
                "coarticulation + anticipatory_coarticulation must not "
                "exceed 1.0 — the onset and offset glides would overlap"
            )
        rng = np.random.default_rng(self.seed)
        self._speaker_params = [
            {
                "formant_scale": float(rng.uniform(*self.formant_scale_range)),
                "rate": float(rng.uniform(*self.rate_range)),
                "amp": float(rng.uniform(0.6, 1.0)),
                # Channel: spectral tilt pole in [-0.4, 0.4] plus a mild
                # resonance at a random frequency (applied in _channel).
                "tilt": float(rng.uniform(-0.4, 0.4)),
                "res_freq": float(rng.uniform(500.0, 3500.0)),
                "res_gain": float(rng.uniform(0.05, 0.25)),
            }
            for _ in range(self.num_train_speakers + self.num_test_speakers)
        ]
        self._rng = rng
        train_speakers = range(self.num_train_speakers)
        test_speakers = range(
            self.num_train_speakers, self.num_train_speakers + self.num_test_speakers
        )
        self._train = self._build_split(train_speakers)
        self._test = self._build_split(test_speakers)
        if self.with_sentences:
            self._add_sentences(self._train, train_speakers)
            self._add_sentences(self._test, test_speakers)

    def _add_sentences(self, loader: DataLoader, speakers) -> None:
        rng = np.random.default_rng(self.seed + 99)
        labels = self.labels
        for n in self.sentence_lengths:
            for k in range(self.sentences_per_length):
                transcript = join_transcript(rng.choice(labels, size=n))
                loader.data.setdefault(transcript, []).extend(
                    self.sentence_audio(transcript, spk, jitter_seed=k * 31 + take)
                    for spk in speakers
                    for take in range(self.takes_per_digit)
                )

    # -- public surface mirroring TIDigits ---------------------------------
    @property
    def train_dataset(self) -> DataLoader:
        return self._train

    @property
    def test_dataset(self) -> DataLoader:
        return self._test

    # -- generation ---------------------------------------------------------
    def _build_split(self, speakers) -> DataLoader:
        data: Dict[str, List[np.ndarray]] = {}
        for spk in speakers:
            for label in self.labels:
                for take in range(self.takes_per_digit):
                    clip = self.isolated_clip(label, spk, take)
                    data.setdefault(label, []).append(clip)
        return DataLoader(data)

    def isolated_clip(self, label: str, speaker: int, take: int = 0) -> np.ndarray:
        """A recorded isolated digit: leading/trailing room tone around the
        spoken digit, like real TI-Digits recordings."""
        rng = np.random.default_rng(take * 104729 + speaker * 7 + 13)
        lead = self.silence(rng.uniform(0.12, 0.22), seed=take * 3 + speaker)
        tail = self.silence(rng.uniform(0.12, 0.22), seed=take * 3 + speaker + 1)
        clip = np.concatenate([lead, self.digit_audio(label, speaker, take), tail])
        import zlib

        # Deterministic across processes (Python's hash() is salted).
        return self._degrade(
            clip, speaker, take * 31 + zlib.crc32(label.encode()) % 997,
            snr_db=self.snr_db_isolated, _use_default=False,
        )

    # -- degradation (difficulty knobs) --------------------------------------
    def _channel(self, signal: np.ndarray, speaker: int) -> np.ndarray:
        """Per-speaker channel coloration: one-pole spectral tilt plus a mild
        two-pole resonance. Host-side scipy; the corpus is generated once."""
        from scipy.signal import lfilter

        p = self._speaker_params[speaker]
        tilted = lfilter([1.0], [1.0, -p["tilt"]], signal)
        w = 2 * np.pi * p["res_freq"] / SAMPLE_RATE
        r = 0.95
        resonant = lfilter(
            [1.0], [1.0, -2 * r * np.cos(w), r * r], signal
        )
        out = tilted + p["res_gain"] * resonant * (1 - r)
        # Keep overall level comparable to the dry signal.
        dry_rms = float(np.sqrt(np.mean(signal**2))) + 1e-9
        wet_rms = float(np.sqrt(np.mean(out**2))) + 1e-9
        return (out * (dry_rms / wet_rms)).astype(np.float32)

    def _degrade(
        self, clip: np.ndarray, speaker: int, noise_seed: int,
        snr_db: tuple | None = None, _use_default: bool = True,
    ) -> np.ndarray:
        """Apply channel coloration and SNR-calibrated additive noise."""
        if snr_db is None and _use_default:
            snr_db = self.snr_db
        if self.channel_filter:
            clip = self._channel(clip, speaker)
        if snr_db is not None:
            import zlib

            key = zlib.crc32(
                f"noise|{speaker}|{noise_seed}|{self.seed}".encode()
            )
            rng = np.random.default_rng(key)
            snr = rng.uniform(*snr_db)
            # Speech RMS estimated over the loud half of the clip so the
            # leading/trailing room tone doesn't deflate the target SNR.
            mag = np.abs(clip)
            loud = clip[mag > np.percentile(mag, 50)]
            speech_rms = float(np.sqrt(np.mean(loud**2))) + 1e-9
            noise_rms = speech_rms / (10.0 ** (snr / 20.0))
            clip = clip + rng.normal(0.0, noise_rms, clip.shape)
        return clip.astype(np.float32)

    def digit_audio_with_phone_segments(
        self, label: str, speaker: int, jitter_seed: int = 0
    ):
        """Like digit_audio, but also returns the TRUE per-phone sample
        spans [(start, end), ...] — generation ground truth for
        phone-alignment and phone-bootstrap experiments (the phone pieces
        are concatenated, so boundaries are exact)."""
        audio, bounds = self._digit_audio_impl(label, speaker, jitter_seed)
        return audio, bounds

    def digit_audio(self, label: str, speaker: int, jitter_seed: int = 0) -> np.ndarray:
        """One spoken digit: 3 formant phones + noise, int16-scale float32."""
        return self._digit_audio_impl(label, speaker, jitter_seed)[0]

    def _digit_audio_impl(self, label: str, speaker: int, jitter_seed: int):
        params = self._speaker_params[speaker]
        # Deterministic across processes (Python's hash() is salted).
        import zlib

        key = zlib.crc32(f"{label}|{speaker}|{jitter_seed}|{self.seed}".encode())
        rng = np.random.default_rng(key)
        pieces = []
        prev_eff = None  # previous phone's realized (f1, f2) for the glide
        templates = list((self.phone_templates or _DIGIT_PHONES)[label])
        for i, (f1, f2) in enumerate(templates):
            dur = rng.uniform(0.055, 0.10) * params["rate"]
            n = max(int(dur * SAMPLE_RATE), 240)
            t = np.arange(n) / SAMPLE_RATE
            s1 = params["formant_scale"] * (1 + rng.normal(0, self.formant_jitter))
            s2 = params["formant_scale"] * (1 + rng.normal(0, self.formant_jitter))
            env = np.hanning(2 * n)[:n] * 0.5 + 0.5  # attack envelope
            # Vibrato + slow amplitude modulation: keeps per-state feature
            # variance realistic so trained covariances are not near-singular.
            vib = 1.0 + 0.01 * np.sin(2 * np.pi * 6.0 * t + rng.uniform(0, 2 * np.pi))
            am = 1.0 + 0.15 * np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 2 * np.pi))
            n_tr = int(n * self.coarticulation) if prev_eff is not None else 0
            # Anticipation targets the next phone's SCALED nominal formants
            # (its jitter is not drawn yet — drawing it here would shift
            # the rng stream and break bit-parity at zero coarticulation).
            n_ant = (int(n * self.anticipatory_coarticulation)
                     if i + 1 < len(templates) else 0)
            if n_tr > 0 or n_ant > 0:
                # Formant trajectory: onset glides from the previous
                # phone's realization, offset glides toward the next
                # phone's target. Phase is the integral of instantaneous
                # frequency; the constant-formant branch below keeps the
                # legacy expression (and bitstream).
                onset = np.zeros(n)
                if n_tr > 0:
                    onset[:n_tr] = np.linspace(1.0, 0.0, n_tr,
                                               endpoint=False)
                offset = np.zeros(n)
                if n_ant > 0:
                    offset[n - n_ant:] = np.linspace(0.0, 1.0, n_ant,
                                                     endpoint=False)
                p1 = prev_eff[0] if prev_eff is not None else f1 * s1
                p2 = prev_eff[1] if prev_eff is not None else f2 * s2
                if n_ant > 0:
                    nf1, nf2 = templates[i + 1]
                    a1 = nf1 * params["formant_scale"]
                    a2 = nf2 * params["formant_scale"]
                else:
                    a1, a2 = f1 * s1, f2 * s2
                f1_traj = (f1 * s1 + (p1 - f1 * s1) * onset
                           + (a1 - f1 * s1) * offset)
                f2_traj = (f2 * s2 + (p2 - f2 * s2) * onset
                           + (a2 - f2 * s2) * offset)
                phone = (
                    np.sin(2 * np.pi * np.cumsum(f1_traj * vib) / SAMPLE_RATE
                           + rng.uniform(0, 2 * np.pi))
                    + 0.6 * np.sin(2 * np.pi * np.cumsum(f2_traj * vib) / SAMPLE_RATE
                                   + rng.uniform(0, 2 * np.pi))
                ) * env * am
                # The next onset glides from where this trajectory actually
                # ENDED — with anticipation on, that is near the next
                # phone's target, so combined glides stay continuous
                # instead of zigzagging at the boundary. Equals
                # (f1*s1, f2*s2) whenever anticipation is off.
                prev_eff = (float(f1_traj[-1]), float(f2_traj[-1]))
            else:
                phone = (
                    np.sin(2 * np.pi * f1 * s1 * np.cumsum(vib) / SAMPLE_RATE
                           + rng.uniform(0, 2 * np.pi))
                    + 0.6 * np.sin(2 * np.pi * f2 * s2 * np.cumsum(vib) / SAMPLE_RATE
                                   + rng.uniform(0, 2 * np.pi))
                ) * env * am
                prev_eff = (f1 * s1, f2 * s2)
            pieces.append(phone)
        sig = np.concatenate(pieces)
        sig += rng.normal(0, 0.06, sig.shape)
        sig *= params["amp"] * 8000.0
        bounds, off = [], 0
        for p in pieces:
            bounds.append((off, off + len(p)))
            off += len(p)
        return sig.astype(np.float32), bounds

    def silence(self, duration: float = 0.08, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        n = int(duration * SAMPLE_RATE)
        return (rng.normal(0, 40.0, n)).astype(np.float32)

    def sentence_audio(
        self, transcript: str, speaker: int, jitter_seed: int = 0, gap: float = 0.06
    ) -> np.ndarray:
        """Multi-digit utterance: silence-separated digit concatenation (the
        reference's get_combined trick plus inter-word gaps)."""
        return self.sentence_audio_with_segments(
            transcript, speaker, jitter_seed, gap
        )[0]

    def sentence_audio_with_segments(
        self, transcript: str, speaker: int, jitter_seed: int = 0, gap: float = 0.06
    ):
        """Like sentence_audio, but also returns the TRUE word segments as
        [(label, start_sample, end_sample)] — the degradations (channel
        filter, additive noise) are length-preserving, so the concatenation
        offsets are exact ground truth for alignment tests."""
        rng = np.random.default_rng(jitter_seed * 7919 + speaker)
        pieces = [self.silence(gap * rng.uniform(0.5, 1.5), seed=jitter_seed)]
        segments = []
        offset = len(pieces[0])
        for i, label in enumerate(transcript):
            digit = self.digit_audio(label, speaker, jitter_seed + i)
            segments.append((label, offset, offset + len(digit)))
            offset += len(digit)
            pieces.append(digit)
            tail = self.silence(gap * rng.uniform(0.5, 1.5), seed=jitter_seed + i)
            offset += len(tail)
            pieces.append(tail)
        sentence = np.concatenate(pieces)
        import zlib

        key = zlib.crc32(transcript_seed_key(transcript)) % 99991
        return self._degrade(sentence, speaker, jitter_seed * 131 + key), segments

    def sentence_corpus(
        self,
        transcripts: Sequence[str],
        speakers,
        takes: int = 1,
        gap: float = 0.06,
    ) -> Dict[str, List[np.ndarray]]:
        """Transcript -> utterances map, the shape the continuous trainer eats
        (reference scripts/project6_train.py:29-33)."""
        out: Dict[str, List[np.ndarray]] = {}
        for transcript in transcripts:
            clips = []
            for spk in speakers:
                for take in range(takes):
                    clips.append(
                        self.sentence_audio(transcript, spk, jitter_seed=take, gap=gap)
                    )
            out[transcript] = clips
        return out
