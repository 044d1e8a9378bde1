"""Word HMMs and the flattened composite model, as stacked NumPy arrays.

WordHMM holds means (S, D), covariances (S, D, D) and a dense log_a (S, S);
CompositeHMM is the concatenation of its words plus the integer boundary
vectors the decoder's trellis and word compaction read. Tensors are made from
these arrays where an op needs them, on the device the caller picks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Default inter-word log transition penalty, log(0.005).
DEFAULT_WORD_PENALTY = float(np.log(0.005))


def uniform_forward_log_a(num_states: int) -> np.ndarray:
    """Initial transition matrix: row i uniform over states i..S-1, in log space."""
    log_a = np.full((num_states, num_states), -np.inf, np.float32)
    for i in range(num_states):
        log_a[i, i:] = np.log(1.0 / (num_states - i))
    return log_a


def _features_on(features, device):
    """(features tensor, its device): a tensor stays where it is; an array
    goes to ``device`` (the card unless "cpu")."""
    import torch

    from ..device import resolve_device

    if isinstance(features, torch.Tensor):
        return features, features.device
    dev = resolve_device(device)
    return torch.as_tensor(np.asarray(features, np.float32), device=dev), dev


def _emission_params(model, device):
    """The model's whitening GaussianParams on ``device``, made once per
    device."""
    from ..device import resolve_device
    from ..ops.gaussian import make_gaussian_params

    dev = resolve_device(device)
    if dev not in model._emission_cache:
        model._emission_cache[dev] = make_gaussian_params(model.means, model.covariances,
                                                          device=dev)
    return model._emission_cache[dev]


def _log_likelihoods(model, features, device):
    from ..ops.gaussian import gaussian_log_pdf

    features, dev = _features_on(features, device)
    return gaussian_log_pdf(_emission_params(model, dev), features)


@dataclass
class WordHMM:
    """A single left-to-right word model."""

    label: str
    means: np.ndarray  # (S, D)
    covariances: np.ndarray  # (S, D, D)
    log_a: np.ndarray  # (S, S), -inf for zero-probability transitions
    _emission_cache: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def emission_params(self, device=None):
        """Whitening GaussianParams of the states, on ``device`` (the card
        unless "cpu"), made once per device."""
        return _emission_params(self, device)

    def log_likelihoods(self, features, device=None):
        """(T, D) -> (T, S) emission log-densities, on the features' device
        if they are a tensor, else on ``device``."""
        return _log_likelihoods(self, features, device)

    def predict(self, features, length=None, device=None):
        """Viterbi score and state path (T,) of one utterance through the
        word (entry pinned to state 0, score at the last state)."""
        import torch

        from ..ops.viterbi import viterbi_banded

        log_b = self.log_likelihoods(features, device)
        return viterbi_banded(log_b, torch.as_tensor(self.log_a, device=log_b.device), length)


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
        self._emission_cache = {}  # device -> whitening GaussianParams

    def emission_params(self, device=None):
        """Whitening GaussianParams of the states, on ``device`` (the card
        unless "cpu"), made once per device."""
        return _emission_params(self, device)

    def log_likelihoods(self, features, device=None):
        """(..., T, D) features -> (..., T, S) single-Gaussian log-densities
        (the whitening layout), on the features' device if they are a
        tensor, else on ``device`` (the card unless "cpu"). The n-best and
        lattice searches score with it when no log_b is given."""
        return _log_likelihoods(self, features, device)

    def viterbi(self, features, length=None, device=None):
        """One utterance's composite decode: (score, path (T,) int32) of the
        dense trellis (viterbi_composite) on the whitening emissions."""
        from ..ops.viterbi import viterbi_composite

        log_b = self.log_likelihoods(features, device)
        return viterbi_composite(log_b, self.log_a, self.lower_of_state, self.is_entry,
                                 self.is_exit, self.penalty, length)

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

    def word_state_range(self, label: str) -> Tuple[int, int]:
        """[first, last + 1) composite states of the word ``label``."""
        w = self.labels.index(label)
        return int(self.lowers[w]), int(self.uppers[w]) + 1


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


def sentence_hmm(labels: str, models: Dict[str, WordHMM]) -> CompositeHMM:
    """The word models concatenated in transcript order (the training-time
    sentence HMM). Cross-word transitions inside the skip-2 band are free
    (log 0), as the reference's sparse matrix returns 0 for every pair it
    never stored; that is what lets alignments flow between words."""
    composite = stack_word_models([models[lab] for lab in labels])
    word_of = composite.word_of_state
    cross = word_of[:, None] != word_of[None, :]
    s = composite.num_states
    frm = np.arange(s)[:, None]
    to = np.arange(s)[None, :]
    band = (frm <= to) & (frm >= to - 2)
    composite.log_a = np.where(cross & band, 0.0, composite.log_a).astype(np.float32)
    return composite


def from_numpy_models(labels, means, covariances, log_a, weights=None) -> list:
    """Per-word parameter arrays (as the JAX package's models hold them:
    means (S_w, D), covariances (S_w, D, D), log_a (S_w, S_w)) -> the port's
    WordHMMs, in the order given. With ``weights`` (one (S_w, K) array a
    word; means (S_w, K, D), covariances (S_w, K, D, D)) -> GMMWordHMMs.
    Arrays are copied as float32."""
    n = len(labels)
    if not (n == len(means) == len(covariances) == len(log_a)) or (
            weights is not None and len(weights) != n):
        raise ValueError("labels, means, covariances, log_a and weights differ in length")
    if weights is not None:
        from .gmm_hmm import GMMWordHMM

        return [
            GMMWordHMM(label=str(lab), means=np.array(m, np.float32),
                       covariances=np.array(c, np.float32),
                       weights=np.array(w, np.float32), log_a=np.array(a, np.float32))
            for lab, m, c, w, a in zip(labels, means, covariances, weights, log_a)
        ]
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
