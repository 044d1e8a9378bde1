"""Typed configuration layer.

The reference has no config system at all: hyperparameters live as dataclass
defaults, mutated class attributes (scripts/project6_interactive.py:20-22),
private-attribute pokes (project5_test_ndigits_with_sil.py:62), and in-file
constants (project5_test_ndigits_no_sil.py:52) — SURVEY.md §5. This module
provides one typed root config with JSON-file and KEY=VALUE override loading,
so every script parameter is declarative and reproducible.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class FrontEndConfig:
    sample_rate: float = 16000.0
    n_fft: int = 320
    hop_length: int = 160
    n_mels: int = 40
    n_mfcc: int = 13
    fmin: float = 133.33
    fmax: float = 6855.4976
    # "per_frame" (reference parity) or "cmvn" (per-utterance cepstral
    # mean/variance normalization — see ops/mfcc.MFCCConfig.normalization).
    # Checkpoints record this in their manifest so decoding scripts pick the
    # matching front-end automatically.
    normalization: str = "per_frame"

    def mfcc_config(self):
        from ..ops.mfcc import MFCCConfig

        return MFCCConfig(
            sample_rate=self.sample_rate,
            n_fft=self.n_fft,
            hop_length=self.hop_length,
            n_mels=self.n_mels,
            n_mfcc=self.n_mfcc,
            fmin=self.fmin,
            fmax=self.fmax,
            normalization=self.normalization,
        )


@dataclass
class TrainConfig:
    num_states: int = 5
    silence_states: int = 3
    max_iterations: int = 100
    cov_reg: float = 0.001
    init_cov: float = 0.01
    length_multiple: int = 128


@dataclass
class ContinuousConfig:
    max_iterations: int = 100
    cov_reg: float = 0.001
    silence_bootstrap: bool = True
    insert_silence: bool = True
    # "viterbi" (reference segmental update) or "baum_welch" (soft EM).
    update: str = "viterbi"


@dataclass
class DecodeConfig:
    # The reference's default is log(0.005) (hidden_markov_model.py:419);
    # its scripts tune -100 (with silence) / -250 (without).
    word_penalty: float = -100.0
    use_silence: bool = True


@dataclass
class EndpointConfig:
    frame_time: float = 0.01
    speech_high_threshold: float = 0.08
    speech_low_threshold: float = 0.01
    silence_duration_threshold: float = 0.02


@dataclass
class Config:
    """Root config for training / evaluation / interactive scripts."""

    data_root: str = "./ConvertedTIDigits"
    checkpoint_dir: str = ".cache/cs304_tpu_models"
    labels: List[str] = field(
        default_factory=lambda: ["1", "2", "3", "4", "5", "6", "7", "8", "9", "O", "Z"]
    )
    frontend: FrontEndConfig = field(default_factory=FrontEndConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    continuous: ContinuousConfig = field(default_factory=ContinuousConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    endpoint: EndpointConfig = field(default_factory=EndpointConfig)

    # -- loading / overriding -------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Config":
        cfg = cls()
        cfg.apply(data)
        return cfg

    def apply(self, data: Dict[str, Any]) -> None:
        for key, value in data.items():
            self._set_path(key, value)

    def apply_overrides(self, overrides: List[str]) -> None:
        """KEY=VALUE strings with dotted paths, e.g. 'decode.word_penalty=-250'."""
        for item in overrides:
            key, _, raw = item.partition("=")
            if not _:
                raise ValueError(f"override must be KEY=VALUE: {item!r}")
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            self._set_path(key.strip(), value)

    def _set_path(self, dotted: str, value: Any) -> None:
        obj: Any = self
        parts = dotted.split(".")
        for part in parts[:-1]:
            if not hasattr(obj, part):
                raise KeyError(f"unknown config section {part!r} in {dotted!r}")
            obj = getattr(obj, part)
        leaf = parts[-1]
        if dataclasses.is_dataclass(obj) and isinstance(value, dict) and dataclasses.is_dataclass(getattr(obj, leaf, None)):
            for k, v in value.items():
                self._set_path(f"{dotted}.{k}", v)
            return
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown config key {leaf!r} in {dotted!r}")
        current = getattr(obj, leaf)
        if current is not None and not isinstance(value, type(current)):
            if isinstance(current, float) and isinstance(value, int):
                value = float(value)
            elif isinstance(current, list) and isinstance(value, list):
                pass
            else:
                raise TypeError(
                    f"config {dotted!r}: expected {type(current).__name__}, "
                    f"got {type(value).__name__}"
                )
        setattr(obj, leaf, value)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
