"""Shared model-dict stacking for sentence-topology consumers.

The trainers, the aligner and MAP adaptation all need the same
prologue: sort the labels, validate the silence model, stack every word
model's parameters into padded (L, S_max, ...) global arrays, and gather them
onto a transcript's sentence state space. A port of
cs304_tpu/models/stacking.py: single-Gaussian dicts stack as they are; a
dict with any GMM lifts every model to K_max mixtures.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .train_continuous import _sentence_log_a, _topology, insert_silence


@dataclass(frozen=True)
class StackedModels:
    """Padded global arrays over a sorted model dict.

    Single-Gaussian dicts: means (L, S, D), covariances (L, S, D, D;
    identity in padded slots), weights None. Any GMM present: every model
    lifted to K_max mixtures, means (L, S, K, D), covariances
    (L, S, K, D, D), weights (L, S, K); zero-weight padding mixtures
    contribute log 0 and drop out of the logsumexp. log_a (L, S, S; -inf
    padded) either way."""

    labels: List[str]
    label_index: Dict[str, int]
    state_counts: Dict[str, int]
    s_max: int
    dim: int
    means: np.ndarray
    covariances: np.ndarray
    log_a: np.ndarray  # (L, S, S), -inf padded
    weights: Optional[np.ndarray] = None

    @property
    def is_gmm(self) -> bool:
        return self.weights is not None

    def sentence(self, sentence: str, cross_word: str = "exit_only"):
        """Gather onto a sentence's state space.

        Returns (topo, log_a_sent (S_sent, S_sent), emission arrays): (means,
        covs) for a Gaussian stack, (means, covs, weights) for a GMM one."""
        topo = _topology(sentence, self.state_counts, self.label_index)
        log_a_sent = _sentence_log_a(topo, self.log_a, cross_word)
        lab, loc = topo.lab_of_state, topo.loc_of_state
        emission = (self.means[lab, loc], self.covariances[lab, loc])
        if self.is_gmm:
            emission += (self.weights[lab, loc],)
        return topo, log_a_sent, emission

    def sentence_for(self, transcript: str, insert_sil: bool,
                     cross_word: str = "exit_only"):
        """Validate a user transcript and gather its (optionally
        silence-interleaved) sentence. Returns (sentence, topo, log_a_sent,
        emission arrays)."""
        missing = sorted(set(transcript) - set(self.labels))
        if missing:
            raise ValueError(
                f"transcript {transcript!r} uses unknown words {missing}; "
                f"known: {self.labels}"
            )
        if not transcript:
            raise ValueError("empty transcript")
        sentence = insert_silence(transcript) if insert_sil else transcript
        return (sentence, *self.sentence(sentence, cross_word))


def stack_models(
    models: Dict[str, object], require_silence: bool = False
) -> StackedModels:
    """Stack a model dict (WordHMM / GMMWordHMM / mixed: a mixed dict lifts
    its single-Gaussian models to one-mixture rows)."""
    from .gmm_hmm import pad_mixture_params

    if not models:
        raise ValueError("empty model dict")
    if require_silence and "S" not in models:
        raise ValueError(
            "insert_sil=True needs a silence model 'S' in the model dict "
            "(train one with project5_train_no_empty or pass insert_sil=False)"
        )
    labels = sorted(models)
    label_index = {l: i for i, l in enumerate(labels)}
    state_counts = {l: models[l].num_states for l in labels}
    s_max = max(state_counts.values())
    l_num = len(labels)
    dim = int(models[labels[0]].means.shape[-1])
    is_gmm = any(getattr(models[l], "weights", None) is not None for l in labels)

    log_a = np.full((l_num, s_max, s_max), -np.inf, np.float32)
    for l, i in label_index.items():
        s = state_counts[l]
        log_a[i, :s, :s] = models[l].log_a
    weights = None
    if is_gmm:
        k_max = max(getattr(models[l], "num_mixtures", 1) for l in labels)
        means = np.zeros((l_num, s_max, k_max, dim), np.float32)
        covs = np.tile(np.eye(dim, dtype=np.float32), (l_num, s_max, k_max, 1, 1))
        weights = np.zeros((l_num, s_max, k_max), np.float32)
        for l, i in label_index.items():
            s = state_counts[l]
            means[i, :s], covs[i, :s], weights[i, :s] = pad_mixture_params(
                models[l], k_max)
    else:
        means = np.zeros((l_num, s_max, dim), np.float32)
        covs = np.tile(np.eye(dim, dtype=np.float32), (l_num, s_max, 1, 1))
        for l, i in label_index.items():
            m = models[l]
            s = state_counts[l]
            means[i, :s] = m.means
            covs[i, :s] = m.covariances
    return StackedModels(
        labels=labels, label_index=label_index, state_counts=state_counts,
        s_max=s_max, dim=dim, means=means, covariances=covs, log_a=log_a,
        weights=weights,
    )


def enrollment_batches(
    stacked: StackedModels,
    labeled_features: Dict[str, Sequence[np.ndarray]],
    insert_sil: bool,
    cross_word: str,
    length_multiple: int = 64,
):
    """Yield (topo, log_a_sent, emission, padded) per non-empty transcript
    group — the shared enrollment/alignment loop."""
    from ..data.batching import pad_batch

    if not labeled_features:
        raise ValueError("no enrollment utterances")
    for transcript, features in labeled_features.items():
        if not features:
            continue
        _sentence, topo, log_a_sent, emission = stacked.sentence_for(
            transcript, insert_sil, cross_word
        )
        padded = pad_batch(
            [np.asarray(f, np.float32) for f in features], length_multiple
        )
        yield topo, log_a_sent, emission, padded
