"""TI-Digits corpus plumbing.

Mirrors the reference's dataset layer (src/loe_speech_recognition/ti_digits.py):
directory walk over <root>/{Adults,Children}/TIDIGITS/{TRAIN,TEST}, label parsed
from the filename minus the trailing take letter ("1a.wav" -> "1",
ti_digits.py:119-123), lazy per-file WAV loading cast to float32
(ti_digits.py:130-134), label->clips mapping with n-digit filtering and
synthetic concatenation of multi-digit audio (ti_digits.py:70-83).

Host-side by design: filesystem walking and WAV decode feed device batches; the
compute path starts at cs304_tpu_torch.ops.mfcc. A copy of
cs304_tpu/data/ti_digits.py (numpy and scipy only); DIGIT_LABELS lives here
and data/batching.py re-exports it.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import numpy as np
import scipy.io.wavfile

logger = logging.getLogger(__name__)

# Label -> digit value map, including "O" (oh) = 0 and "Z" (zero) = 10
# (reference ti_digits.py:13-26).
TI_DIGITS_LABELS: Dict[str, int] = {
    "1": 1, "2": 2, "3": 3, "4": 4, "5": 5, "6": 6, "7": 7, "8": 8, "9": 9,
    "O": 0, "Z": 10,
}

DIGIT_LABELS: Tuple[str, ...] = tuple(TI_DIGITS_LABELS.keys())
SILENCE_LABEL = "S"


def parse_filename_label(file_name: str) -> str:
    """'82a.wav' -> '82' (drop extension and the trailing take letter)."""
    return file_name.split(".")[0][:-1]


def load_wav(path: str) -> np.ndarray:
    """WAV -> float32 1-D signal (same cast as the reference, ti_digits.py:130-134)."""
    _, signal = scipy.io.wavfile.read(path)
    return np.asarray(signal, np.float32)


@dataclass
class DataLoader:
    """Label -> list of clips (file paths when lazy, arrays when eager)."""

    data: Dict[str, List]

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, str]]:
        for label, clips in self.data.items():
            for clip in clips:
                yield self._materialize(clip), label

    def __getitem__(self, label: str) -> List[np.ndarray]:
        return [self._materialize(c) for c in self.data[label]]

    def merge(self, other: "DataLoader") -> "DataLoader":
        """Non-mutating merge (the reference's __add__ mutates self.data in
        place, ti_digits.py:43-50 — a documented defect we do not replicate)."""
        combined: Dict[str, List] = {k: list(v) for k, v in self.data.items()}
        for k, v in other.data.items():
            combined.setdefault(k, []).extend(v)
        return DataLoader(combined)

    __add__ = merge

    @property
    def labels(self) -> List[str]:
        return list(self.data.keys())

    def num_clips(self) -> int:
        return sum(len(v) for v in self.data.values())

    def get_combined(self, labels: str, key: int = 0) -> np.ndarray:
        """Concatenate one clip per label into synthetic multi-digit audio
        (reference ti_digits.py:70-77)."""
        return np.concatenate([self[label][key] for label in labels])

    def get_all_n_digits(self, n: int) -> Dict[str, List[np.ndarray]]:
        """All transcripts of exactly n digits (reference ti_digits.py:79-83)."""
        return {
            label: self[label] for label in self.data if len(label) == n
        }

    def subset(self, max_per_label: int) -> "DataLoader":
        """First k clips of every label (the reference's sweep scripts slice
        5 clips per label, scripts/project5_find_trans_ndigits_no_sil.py:66-78)."""
        return DataLoader({k: v[:max_per_label] for k, v in self.data.items()})

    @staticmethod
    def _materialize(clip) -> np.ndarray:
        if isinstance(clip, str):
            return load_wav(clip)
        return np.asarray(clip, np.float32)

    @classmethod
    def from_folder_path(cls, folder_path: str, lazy: bool = True) -> "DataLoader":
        data: Dict[str, List] = {}
        for dirpath, _dirnames, filenames in os.walk(folder_path):
            for filename in filenames:
                if not filename.lower().endswith(".wav"):
                    continue
                filepath = os.path.join(dirpath, filename)
                label = parse_filename_label(filename)
                clip = filepath if lazy else load_wav(filepath)
                data.setdefault(label, []).append(clip)
        if not data:
            logger.warning("No WAV files found under %s", folder_path)
        return cls(data)


@dataclass
class TIDigits:
    """TI-Digits train/test splits (reference ti_digits.py:144-203)."""

    folder_path: str
    include_adult: bool = True
    include_children: bool = True
    lazy: bool = True

    _train: DataLoader = field(init=False)
    _test: DataLoader = field(init=False)

    def __post_init__(self) -> None:
        if not (self.include_adult or self.include_children):
            raise ValueError("At least one of adult/children must be included")
        train, test = DataLoader({}), DataLoader({})
        groups = []
        if self.include_adult:
            groups.append("Adults")
        if self.include_children:
            groups.append("Children")
        for group in groups:
            base = os.path.join(self.folder_path, group, "TIDIGITS")
            train = train.merge(
                DataLoader.from_folder_path(os.path.join(base, "TRAIN"), self.lazy)
            )
            test = test.merge(
                DataLoader.from_folder_path(os.path.join(base, "TEST"), self.lazy)
            )
        self._train, self._test = train, test

    @property
    def train_dataset(self) -> DataLoader:
        return self._train

    @property
    def test_dataset(self) -> DataLoader:
        return self._test
