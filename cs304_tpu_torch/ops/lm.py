"""Word-bigram language model for continuous decoding and n-best rescoring.

The reference's inter-word transition is one flat penalty applied to every
word-exit -> word-entry edge (hidden_markov_model.py:419,541-544). Because
this framework's composite topology is a dense (S, S) transition matrix
(ops/viterbi.composite_transition_matrix), a bigram LM needs NO new decode
machinery: the scalar penalty generalizes to a per-(from word, to word)
log-probability matrix broadcast into the exit rows of the entry columns,
and the same max-plus scan decodes with full bigram context. Decode score
becomes   acoustic + lm_weight * log P(w | w') + penalty   per word edge —
the standard log-linear combination, with the flat penalty kept as the
word-insertion penalty, so lm_weight=0 reproduces the reference decoder
exactly.

Training: add-k-smoothed bigram counts over transcript label sequences.
With a silence model the decode topology interleaves optional silences
("4Z2" decodes over "S4SZS2S" states), so `insert_silence=True` trains the
LM on the silence-interleaved sentences — S edges then carry real
probabilities, and direct word->word hops (which the training sentences
never contain) are disfavoured, matching the trained acoustic topology.
Note the granularity trade: in interleaved training every word pair is
separated by S, so what survives is word FREQUENCY after silence (the S
rows), not word order — order context requires insert_silence=False, at
the price of uninformed S edges (they fall back to the smoothing floor).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["WordBigram", "train_word_bigram", "WordTrigram",
           "train_word_trigram", "pair_penalty_matrix",
           "word_pair_penalties", "rescore_nbest"]

NEG = -np.inf


@dataclass(frozen=True)
class WordBigram:
    labels: List[str]          # vocabulary, index order of the matrices
    log_p: np.ndarray          # (W, W) log P(labels[j] | labels[i])
    log_p_init: np.ndarray     # (W,)  log P(labels[j] | <s>)
    log_p_final: np.ndarray    # (W,)  log P(</s> | labels[i])

    @property
    def index(self) -> Dict[str, int]:
        return {l: i for i, l in enumerate(self.labels)}

    def sequence_log_prob(self, words: Sequence[str]) -> float:
        """LM log-probability of a word sequence including sentence
        boundaries. Unknown words raise KeyError — the decoder vocabulary
        is closed, so there is no out-of-vocabulary fallback here."""
        idx = self.index
        ids = [idx[w] for w in words]
        if not ids:
            return 0.0
        lp = float(self.log_p_init[ids[0]])
        for a, b in zip(ids, ids[1:]):
            lp += float(self.log_p[a, b])
        lp += float(self.log_p_final[ids[-1]])
        return lp


def train_word_bigram(
    transcripts: Sequence[str],
    labels: Sequence[str],
    smoothing: float = 0.5,
    insert_silence: bool = False,
    silence_label: str = "S",
) -> WordBigram:
    """Add-k-smoothed bigram over single-character word transcripts.

    transcripts: digit strings as the corpus stores them (e.g. "4Z2Z1").
    labels: the closed decode vocabulary (include the silence label when
    insert_silence). Each transcript contributes <s> w1 ... wn </s> counts;
    insert_silence counts over the silence-interleaved sentence instead
    (reference insert_silence, hidden_markov_model.py:794-797).
    """
    labels = list(labels)
    idx = {l: i for i, l in enumerate(labels)}
    w = len(labels)
    counts = np.full((w, w), smoothing, np.float64)
    init = np.full(w, smoothing, np.float64)
    final = np.full(w, smoothing, np.float64)
    for tr in transcripts:
        words = list(tr)
        if insert_silence:
            out = [silence_label]
            for ch in words:
                out += [ch, silence_label]
            words = out
        ids = [idx[ch] for ch in words]
        if not ids:
            continue
        init[ids[0]] += 1
        for a, b in zip(ids, ids[1:]):
            counts[a, b] += 1
        final[ids[-1]] += 1
    # Each row i normalizes over continuations of i INCLUDING </s>.
    row_tot = counts.sum(axis=1) + final
    log_p = np.log(counts) - np.log(row_tot)[:, None]
    log_p_final = np.log(final) - np.log(row_tot)
    log_p_init = np.log(init) - np.log(init.sum())
    return WordBigram(
        labels=labels,
        log_p=log_p.astype(np.float32),
        log_p_init=log_p_init.astype(np.float32),
        log_p_final=log_p_final.astype(np.float32),
    )


def word_pair_penalties(
    composite,
    bigram: WordBigram,
    lm_weight: float = 1.0,
    penalty: float | None = None,
) -> np.ndarray:
    """(W, W) inter-word penalties over the composite's word order:
    [w', w] = lm_weight * log P(labels[w] | labels[w']) + penalty.
    Words absent from the bigram vocabulary fall back to the flat penalty
    alone. lm_weight=0 reproduces the flat-penalty decoder."""
    if penalty is None:
        penalty = composite.penalty
    idx = bigram.index
    w_lm = np.asarray(
        [idx.get(lab, -1) for lab in composite.labels], np.int64
    )
    known = w_lm >= 0
    lp = bigram.log_p[np.maximum(w_lm, 0)[:, None],
                      np.maximum(w_lm, 0)[None, :]]
    pair = np.where(known[:, None] & known[None, :],
                    lm_weight * lp, 0.0).astype(np.float32)
    return pair + np.float32(penalty)


def pair_penalty_matrix(
    composite,
    bigram: WordBigram,
    lm_weight: float = 1.0,
    penalty: float | None = None,
) -> np.ndarray:
    """(S, S) per-state expansion of word_pair_penalties for the dense
    composite transition matrix: entry [s', s] = pair[word(s'), word(s)] —
    used by composite_transition_matrix on the word-exit rows of
    word-entry columns (other entries are irrelevant there)."""
    pair = word_pair_penalties(composite, bigram, lm_weight, penalty)
    word_of = np.asarray(composite.word_of_state)
    return pair[word_of[:, None], word_of[None, :]]


def rescore_nbest(
    hyps: Sequence[Tuple[float, str]],
    bigram,
    lm_weight: float = 1.0,
) -> List[Tuple[float, str]]:
    """Re-rank n-best hypotheses by combined score:
    acoustic_score + lm_weight * LM log-prob (with sentence boundaries).
    `bigram` is any model with sequence_log_prob — WordBigram or
    WordTrigram. Returns [(combined_score, text)] sorted best-first."""
    out = [
        (score + lm_weight * bigram.sequence_log_prob(list(text)), text)
        for score, text in hyps
    ]
    out.sort(key=lambda st: -st[0])
    return out


@dataclass(frozen=True)
class WordTrigram:
    """Add-k trigram over the closed decode vocabulary.

    Dense (W, W, W) table — at the 100-word scale that is 4 MB, far below
    any sparse representation's complexity threshold. History slots use
    W as the <s> (boundary) id, so log_p[W, W, j] is P(w_j | <s> <s>) and
    log_p[W, i, j] is P(w_j | <s> w_i); log_p_final[a, b] is P(</s> | a b).
    Same `sequence_log_prob` surface as WordBigram, so rescore_nbest works
    unchanged. First-pass decoding stays bigram (the composite trellis
    carries one word of context); trigrams apply in the second pass —
    n-best (rescore_nbest) or lattice (rescore.lattice_rescore_trigram),
    the standard decoder stack split.
    """

    labels: List[str]
    log_p: np.ndarray        # (W+1, W+1, W) log P(c | a, b)
    log_p_final: np.ndarray  # (W+1, W+1)    log P(</s> | a, b)

    @property
    def index(self) -> Dict[str, int]:
        return {l: i for i, l in enumerate(self.labels)}

    @property
    def boundary(self) -> int:
        return len(self.labels)

    def sequence_log_prob(self, words: Sequence[str]) -> float:
        """LM log-probability including sentence boundaries. Unknown words
        raise KeyError (closed vocabulary, as WordBigram)."""
        idx = self.index
        ids = [idx[w] for w in words]
        if not ids:
            return 0.0  # WordBigram's empty-sequence convention
        s = self.boundary
        a, b = s, s
        lp = 0.0
        for c in ids:
            lp += float(self.log_p[a, b, c])
            a, b = b, c
        lp += float(self.log_p_final[a, b])
        return lp


def train_word_trigram(
    transcripts: Sequence[str],
    labels: Sequence[str],
    smoothing: float = 0.5,
    insert_silence: bool = False,
    silence_label: str = "S",
) -> WordTrigram:
    """Add-k-smoothed trigram (same conventions as train_word_bigram:
    transcripts are label sequences — strings iterate per character,
    tuples per word; every row normalizes over continuations + </s>)."""
    labels = list(labels)
    idx = {l: i for i, l in enumerate(labels)}
    w = len(labels)
    s = w  # boundary history id
    counts = np.full((w + 1, w + 1, w), smoothing, np.float64)
    final = np.full((w + 1, w + 1), smoothing, np.float64)
    for tr in transcripts:
        words = list(tr)
        if insert_silence:
            out = [silence_label]
            for ch in words:
                out += [ch, silence_label]
            words = out
        ids = [idx[ch] for ch in words]
        a, b = s, s
        for c in ids:
            counts[a, b, c] += 1
            a, b = b, c
        final[a, b] += 1
    row_tot = counts.sum(axis=2) + final
    log_p = np.log(counts) - np.log(row_tot)[:, :, None]
    log_p_final = np.log(final) - np.log(row_tot)
    return WordTrigram(
        labels=labels,
        log_p=log_p.astype(np.float32),
        log_p_final=log_p_final.astype(np.float32),
    )
