"""Tied phone-based modeling: a phone inventory + a pronunciation lexicon.

A port of cs304_tpu/models/lexicon.py. The reference (and the flagship tier)
trains one HMM PER WORD (reference hidden_markov_model.py:211-410):
parameters grow linearly with the vocabulary and a new word needs new
recordings. This module adds the standard large-vocabulary architecture on
top of the SAME machinery:

  - a small inventory of 3-state PHONE HMMs shared by every word,
  - a Lexicon mapping each word to its phone sequence,
  - word models COMPOSED on demand by concatenating phone models (free
    exit->entry transitions between phones, the sentence-topology
    convention of ContinuousTrainConfig cross_word="exit_only"),
  - embedded training that pools statistics per PHONE across all words:
    transcripts of words expand to transcripts of phones (silence between
    words only) and feed the UNCHANGED ContinuousTrainer, whose "words" are
    simply phone labels. On a card each of its iterations is one launch of
    the sentence decode mode of the scan-free team kernel (K3).

Parameters stay O(phones) as the vocabulary grows, every occurrence of a
phone in any word trains the same model, and a word never seen in training
decodes the moment it is added to the lexicon (OOV support). The composed
word models feed the ContinuousDecoder untouched (on a card the emission
kernel and the scan-free decode kernel). MAP adaptation adapts the SHARED
phones (map_adapt with expanded transcripts + insert_sil=False), and
gmm_mixtures>1 refines the inventory with embedded K-mixture training.

Training runs on ``device`` (the first card by default; ``device="cpu"``
for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .hmm import WordHMM, uniform_forward_log_a

SILENCE_LABEL = "S"


@dataclass(frozen=True)
class Lexicon:
    """word label -> tuple of phone labels."""

    entries: Dict[str, Tuple[str, ...]]

    def __post_init__(self) -> None:
        for word, phones in self.entries.items():
            if not phones:
                raise ValueError(f"word {word!r} has an empty pronunciation")
            if word == SILENCE_LABEL:
                raise ValueError(
                    "the silence label cannot be a lexicon word"
                )

    @property
    def words(self) -> List[str]:
        return sorted(self.entries)

    @property
    def phones(self) -> List[str]:
        return sorted({p for ph in self.entries.values() for p in ph})

    def __getitem__(self, word: str) -> Tuple[str, ...]:
        return self.entries[word]

    def __contains__(self, word: str) -> bool:
        return word in self.entries

    def save(self, path: str) -> None:
        """JSON word -> [phones] (the on-disk pronunciation dictionary)."""
        import json

        with open(path, "w") as f:
            json.dump({w: list(p) for w, p in sorted(self.entries.items())},
                      f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Lexicon":
        import json

        with open(path) as f:
            raw = json.load(f)
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: expected a JSON object of "
                             "word -> [phones]")
        return cls({w: tuple(p) for w, p in raw.items()})

    def with_words(self, new_entries: Dict[str, Sequence[str]]) -> "Lexicon":
        """A new lexicon with extra words (the OOV mechanism: any word made
        of known phones becomes decodable without retraining)."""
        merged = dict(self.entries)
        for w, ph in new_entries.items():
            merged[w] = tuple(ph)
        return Lexicon(merged)

    def expand_transcript(
        self, words: Sequence[str], insert_silence: bool = True
    ) -> tuple:
        """Word transcript -> phone transcript, silence between WORDS only
        (the reference interleaves silence between words,
        hidden_markov_model.py:794-797; phones inside a word connect
        directly). Feed the result to ContinuousTrainer with
        cfg.insert_silence=False."""
        if isinstance(words, str):  # a digit-string style transcript
            words = list(words)
        out: List[str] = [SILENCE_LABEL] if insert_silence else []
        for w in words:
            out.extend(self.entries[w])
            if insert_silence:
                out.append(SILENCE_LABEL)
        return tuple(out)


def compose_word_models(
    lexicon: Lexicon,
    phone_models: Dict[str, WordHMM],
    words: Sequence[str] | None = None,
) -> Dict[str, WordHMM]:
    """Build per-word HMMs by concatenating phone models.

    Block-diagonal transitions with a FREE (log 1 = 0) exit->entry move
    between consecutive phones — the same cross-unit convention the
    embedded trainer's sentence topology uses (exit_only), so decode-time
    word internals match what phone training aligned. The silence model is
    passed through unchanged when present in phone_models. K-mixture GMM
    phone models compose to GMMWordHMMs (mixed inventories lift the
    Gaussian phones to one-mixture rows).
    """
    from .gmm_hmm import GMMWordHMM

    out: Dict[str, WordHMM] = {}
    for word in (lexicon.words if words is None else words):
        phones = lexicon[word]
        missing = [p for p in phones if p not in phone_models]
        if missing:
            raise ValueError(
                f"word {word!r} uses untrained phones {missing}"
            )
        parts = [phone_models[p] for p in phones]
        s_total = sum(m.num_states for m in parts)
        dims = {int(m.means.shape[-1]) for m in parts}
        if len(dims) != 1:
            raise ValueError(
                f"word {word!r}: phones disagree on feature dim {dims}"
            )
        log_a = np.full((s_total, s_total), -np.inf, np.float32)
        base = 0
        for m in parts:
            n = m.num_states
            log_a[base : base + n, base : base + n] = m.log_a
            if base + n < s_total:
                log_a[base + n - 1, base + n] = 0.0  # free exit -> entry
            base += n
        is_gmm = any(isinstance(m, GMMWordHMM) for m in parts)
        if is_gmm:
            from .gmm_hmm import pad_mixture_params

            k_max = max(
                m.num_mixtures if isinstance(m, GMMWordHMM) else 1
                for m in parts
            )
            lifted = [pad_mixture_params(m, k_max) for m in parts]
            out[word] = GMMWordHMM(
                label=word,
                means=np.concatenate([x[0] for x in lifted]),
                covariances=np.concatenate([x[1] for x in lifted]),
                weights=np.concatenate([x[2] for x in lifted]),
                log_a=log_a,
            )
        else:
            out[word] = WordHMM(
                label=word,
                means=np.concatenate([m.means for m in parts], axis=0),
                covariances=np.concatenate(
                    [m.covariances for m in parts], axis=0
                ),
                log_a=log_a,
            )
    if SILENCE_LABEL in phone_models:
        out[SILENCE_LABEL] = phone_models[SILENCE_LABEL]
    return out


def uniform_phone_boot(
    features_by_word: Dict[str, Sequence[np.ndarray]],
    lexicon: Lexicon,
    num_states: int = 3,
    cov_reg: float = 0.01,
) -> Dict[str, WordHMM]:
    """Flat-start phone models from isolated word clips.

    The word-tier boot splits each clip uniformly over the word's states
    (reference hidden_markov_model.py:359-389); here each (silence-stripped)
    clip splits uniformly over its word's phone sequence x num_states
    slots, and the per-(phone, state) segments POOL ACROSS ALL WORDS — the
    tying that makes 'shared phones' mean shared parameters from the very
    first iteration. Covariances are full, pooled, + cov_reg*I (the boot
    regularizer, reference :387-389 uses 0.01*I).
    """
    pools: Dict[Tuple[str, int], List[np.ndarray]] = {}
    dim = None
    for word, clips in features_by_word.items():
        phones = lexicon[word]
        slots = len(phones) * num_states
        for feats in clips:
            feats = np.asarray(feats)
            t = feats.shape[0]
            if t < slots:
                continue  # too short to give every slot a frame
            dim = feats.shape[1]
            bounds = np.linspace(0, t, slots + 1).astype(int)
            for j in range(slots):
                seg = feats[bounds[j] : bounds[j + 1]]
                if len(seg):
                    pools.setdefault(
                        (phones[j // num_states], j % num_states), []
                    ).append(seg)
    if dim is None:
        raise ValueError("no clip was long enough for the phone boot")
    models: Dict[str, WordHMM] = {}
    for phone in lexicon.phones:
        means = np.zeros((num_states, dim), np.float32)
        covs = np.zeros((num_states, dim, dim), np.float32)
        for s in range(num_states):
            segs = pools.get((phone, s))
            if not segs:
                raise ValueError(
                    f"phone {phone!r} state {s} received no frames in the "
                    "boot — every phone must occur in some training word"
                )
            frames = np.concatenate(segs, axis=0)
            means[s] = frames.mean(axis=0)
            if len(frames) > 1:
                covs[s] = np.cov(frames.T, ddof=1)
            covs[s] += np.eye(dim) * cov_reg
        models[phone] = WordHMM(
            label=phone, means=means, covariances=covs.astype(np.float32),
            log_a=uniform_forward_log_a(num_states),
        )
    return models


def train_phone_models(
    phone_models: Dict[str, WordHMM],
    labeled_features: Dict[object, Sequence[np.ndarray]],
    lexicon: Lexicon,
    config=None,
    mesh=None,
    gmm_mixtures: int = 0,
    device=None,
) -> Tuple[Dict[str, WordHMM], int]:
    """Tied embedded training of the phone inventory, on ``device``.

    labeled_features: WORD transcript (str or tuple) -> utterance features.
    Each transcript is lexicon-expanded to its phone sequence (silence
    between words) and the UNCHANGED embedded trainer re-estimates the
    phone models — every phone occurrence in every word pools into one
    model per phone. gmm_mixtures > 1 follows the K=1 stage with embedded
    K-mixture GMM refinement (promote_to_gmm + GMMContinuousTrainer over
    the same expanded transcripts); the result composes to GMMWordHMMs.
    Returns (trained phone models, K=1 iterations)."""
    from .train_continuous import ContinuousTrainConfig, ContinuousTrainer

    if config is None:
        config = ContinuousTrainConfig(max_iterations=5, cov_reg=0.1)
    if config.insert_silence:
        config = type(config)(**{
            **config.__dict__, "insert_silence": False,
        })
    expanded = {
        lexicon.expand_transcript(tr): feats
        for tr, feats in labeled_features.items()
    }
    if len(expanded) != len(labeled_features):
        raise ValueError(
            "two transcripts expanded to the same phone sequence — merge "
            "their utterance lists first"
        )
    trainer = ContinuousTrainer(dict(phone_models), config, mesh=mesh,
                                device=device)
    iterations = trainer.train(expanded)
    models = trainer.models()
    if gmm_mixtures > 1:
        from .train_continuous_gmm import (
            GMMContinuousTrainConfig,
            GMMContinuousTrainer,
            promote_to_gmm,
        )

        gtr = GMMContinuousTrainer(
            promote_to_gmm(models, gmm_mixtures),
            GMMContinuousTrainConfig(
                max_iterations=config.max_iterations,
                cov_reg=config.cov_reg, insert_silence=False,
                rtol=config.rtol, atol=config.atol,
                on_empty_state=config.on_empty_state,
                cross_word=config.cross_word,
                length_multiple=min(config.length_multiple, 32),
                silence_label=config.silence_label,
            ),
            mesh=mesh,
            device=device,
        )
        gtr.train(expanded)
        models = gtr.models()
    return models, iterations
