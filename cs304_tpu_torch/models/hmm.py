"""Word HMMs and the flattened composite model, as stacked NumPy arrays.

WordHMM holds means (S, D), covariances (S, D, D) and a dense log_a (S, S);
CompositeHMM is the concatenation of its words plus the integer boundary
vectors the decoder's trellis and word compaction read. Tensors are made from
these arrays where an op needs them, on the device the caller picks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

# Default inter-word log transition penalty, log(0.005).
DEFAULT_WORD_PENALTY = float(np.log(0.005))


def uniform_forward_log_a(num_states: int) -> np.ndarray:
    """Initial transition matrix: row i uniform over states i..S-1, in log space."""
    log_a = np.full((num_states, num_states), -np.inf, np.float32)
    for i in range(num_states):
        log_a[i, i:] = np.log(1.0 / (num_states - i))
    return log_a


@dataclass
class WordHMM:
    """A single left-to-right word model."""

    label: str
    means: np.ndarray  # (S, D)
    covariances: np.ndarray  # (S, D, D)
    log_a: np.ndarray  # (S, S), -inf for zero-probability transitions

    @property
    def num_states(self) -> int:
        return self.means.shape[0]


@dataclass
class CompositeHMM:
    """Flattened multi-word state space for continuous decoding."""

    labels: List[str]
    state_counts: List[int]
    means: np.ndarray  # (S_total, D)
    covariances: np.ndarray  # (S_total, D, D)
    log_a: np.ndarray  # (S_total, S_total) block-diagonal
    penalty: float = DEFAULT_WORD_PENALTY

    def __post_init__(self) -> None:
        bounds = np.cumsum([0] + list(self.state_counts))
        self.lowers = bounds[:-1].astype(np.int32)  # word entry states
        self.uppers = (bounds[1:] - 1).astype(np.int32)  # word exit states
        s = int(bounds[-1])
        self.num_states = s
        lower_of = np.zeros(s, np.int32)
        word_of = np.zeros(s, np.int32)
        for w, lo in enumerate(self.lowers):
            lower_of[lo:] = lo
            word_of[lo:] = w
        self.lower_of_state = lower_of
        self.word_of_state = word_of
        self.is_entry = np.zeros(s, bool)
        self.is_entry[self.lowers] = True
        self.is_exit = np.zeros(s, bool)
        self.is_exit[self.uppers] = True
        self._silence_word = (
            self.labels.index("S") if "S" in self.labels else None
        )

    def path_to_labels(self, path: np.ndarray, skip_silence: bool = True) -> List[str]:
        """State path -> emitted word labels (host walk): a word is emitted at
        the first point, on every word change, and on an exit->entry hop back
        into the same word (a repeated word)."""
        path = np.asarray(path)
        keep = np.ones(len(path), bool)
        keep[1:] = path[1:] != path[:-1]
        points = path[keep]
        words = self.word_of_state[points]
        emit = np.ones(len(points), bool)
        emit[1:] = (words[1:] != words[:-1]) | (
            (points[:-1] == self.uppers[words[1:]])
            & (points[1:] == self.lowers[words[1:]])
        )
        emitted = words[emit]
        if skip_silence and self._silence_word is not None:
            emitted = emitted[emitted != self._silence_word]
        return [self.labels[w] for w in emitted]


def stack_word_models(
    models: Sequence[WordHMM], penalty: float = DEFAULT_WORD_PENALTY
) -> CompositeHMM:
    """Concatenate word models into one composite state space."""
    state_counts = [m.num_states for m in models]
    s_total = sum(state_counts)
    means = np.concatenate([m.means for m in models], axis=0)
    covs = np.concatenate([m.covariances for m in models], axis=0)
    log_a = np.full((s_total, s_total), -np.inf, np.float32)
    base = 0
    for m in models:
        n = m.num_states
        log_a[base : base + n, base : base + n] = m.log_a
        base += n
    return CompositeHMM(
        labels=[m.label for m in models],
        state_counts=state_counts,
        means=means,
        covariances=covs,
        log_a=log_a,
        penalty=penalty,
    )


def from_numpy_models(labels, means, covariances, log_a) -> List[WordHMM]:
    """Per-word parameter arrays (as the JAX package's models hold them:
    means (S_w, D), covariances (S_w, D, D), log_a (S_w, S_w)) -> the port's
    WordHMMs, in the order given. Arrays are copied as float32."""
    if not (len(labels) == len(means) == len(covariances) == len(log_a)):
        raise ValueError("labels, means, covariances and log_a differ in length")
    return [
        WordHMM(
            label=str(lab),
            means=np.array(m, np.float32),
            covariances=np.array(c, np.float32),
            log_a=np.array(a, np.float32),
        )
        for lab, m, c, a in zip(labels, means, covariances, log_a)
    ]


def composite_from_arrays(
    labels, state_counts, means, covariances, log_a,
    penalty: float = DEFAULT_WORD_PENALTY,
) -> CompositeHMM:
    """A stacked composite given as arrays (S_total-sized means, covariances
    and block-diagonal log_a) -> the port's CompositeHMM."""
    return CompositeHMM(
        labels=list(labels),
        state_counts=[int(c) for c in state_counts],
        means=np.array(means, np.float32),
        covariances=np.array(covariances, np.float32),
        log_a=np.array(log_a, np.float32),
        penalty=float(penalty),
    )


def flagship_models(seed: int = 0) -> List[WordHMM]:
    """The flagship's word models: 11 digits (5 states) + silence "S"
    (3 states), random 39-dim full-covariance Gaussians from ``seed``."""
    from ..data.batching import DIGIT_LABELS

    rng = np.random.default_rng(seed)
    models = []
    for label in sorted(list(DIGIT_LABELS) + ["S"]):
        s = 3 if label == "S" else 5
        means = rng.normal(size=(s, 39)).astype(np.float32)
        a = rng.normal(size=(s, 39, 8)).astype(np.float32) * 0.1
        covs = a @ np.transpose(a, (0, 2, 1)) + 0.5 * np.eye(39, dtype=np.float32)
        models.append(
            WordHMM(label=label, means=means, covariances=covs,
                    log_a=uniform_forward_log_a(s))
        )
    return models


def flagship_composite(seed: int = 0) -> CompositeHMM:
    """The 58-state flagship composite (penalty -100)."""
    return stack_word_models(flagship_models(seed), penalty=-100.0)
