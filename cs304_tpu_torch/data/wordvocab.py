"""Generated 100+-word vocabularies over a shared phone inventory (a copy
of cs304_tpu/data/wordvocab.py: NumPy only, over the port's
data/synthetic.py, so vocabularies, lexicons and audio are bitwise the JAX
package's).

The reference's task is an 11-word vocabulary (digits, ti_digits.py:13-26);
everything in this repo was originally validated at that scale (58 composite
states). This module fabricates arbitrarily large word vocabularies for the
scale studies (the JAX package's benchmarks/scale_vocab.py) and the phone
tiers (models/lexicon.py): a fixed inventory of formant-pair
phones, and words that are short sequences drawn FROM that inventory — so
words share phones and confusability grows with vocabulary size, exactly the
regime where composite decoding, beam pruning, and large-slot training have
to prove themselves.

Word labels are fixed-width CVC syllables ("bak", "tes", ...), which keeps
concatenated decoder output (models/decoder.py joins predicted labels with
"") unambiguous: every parse of a concatenation of width-3 labels is the
original sequence. Transcripts are TUPLES of labels (data/synthetic.py
join_transcript), the multi-char form the trainers accept alongside the
reference's digit strings.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .synthetic import SyntheticTIDigits

_CONSONANTS = "bdfgjklmnprstvz"
_VOWELS = "aeiou"


def word_labels(num_words: int) -> List[str]:
    """Deterministic fixed-width pronounceable labels: 'bab', 'bad', ...

    CVC over 15 consonants x 5 vowels gives 1,125 distinct width-3 labels;
    fixed width makes any concatenation uniquely parseable, and no label is
    the silence label "S".
    """
    limit = len(_CONSONANTS) ** 2 * len(_VOWELS)
    if num_words > limit:
        raise ValueError(f"at most {limit} labels available, asked {num_words}")
    out = []
    for c1 in _CONSONANTS:
        for v in _VOWELS:
            for c2 in _CONSONANTS:
                out.append(c1 + v + c2)
                if len(out) == num_words:
                    return out
    return out


def make_phone_inventory(
    num_phones: int = 24, seed: int = 7
) -> List[Tuple[float, float]]:
    """num_phones (f1, f2) formant pairs spread over the vowel plane.

    Placement is farthest-point sampling in (log f1, log f2) under an
    ANISOTROPIC metric: a speaker's formant_scale multiplies both formants
    (synthetic.py digit_audio applies one scale to f1 and f2), which in log
    space translates a phone along the (1, 1) diagonal — so diagonal
    position is speaker-DEPENDENT while the off-diagonal coordinate
    (log f2 - log f1, the formant ratio) is speaker-INVARIANT. The metric
    weights the invariant direction ~4x tighter than the diagonal, so
    selected phones stay distinguishable by held-out speakers whose scale
    was never seen in training. (The first inventory draft used isotropic
    golden-ratio placement; measured held-out word accuracy was near
    chance — 7% at 20 words — because an unseen +-8% scale mapped one
    word's phones onto a diagonal neighbor's templates.)
    """
    rng = np.random.default_rng(seed)
    # Dense candidate cloud over the (f1, f2) plane.
    n_cand = 4096
    f1 = rng.uniform(260.0, 940.0, n_cand)
    f2 = rng.uniform(850.0, 2650.0, n_cand)
    keep = f2 >= f1 + 320.0
    f1, f2 = f1[keep], f2[keep]
    u = (np.log(f1) + np.log(f2)) / 2.0    # diagonal: speaker-scaled
    v = np.log(f2) - np.log(f1)            # ratio: speaker-invariant
    # Distances: the invariant axis counts 4x the scaled axis (a speaker
    # scale of +-8% moves u by +-0.077 and v by 0).
    pts = np.stack([u / 1.0, v / 0.25], axis=1)

    chosen = [int(np.argmax(v))]  # start from the most extreme ratio
    d_min = np.linalg.norm(pts - pts[chosen[0]], axis=1)
    for _ in range(1, num_phones):
        nxt = int(np.argmax(d_min))
        chosen.append(nxt)
        d_min = np.minimum(d_min, np.linalg.norm(pts - pts[nxt], axis=1))
    return [
        (round(float(f1[i]), 1), round(float(f2[i]), 1)) for i in chosen
    ]


def _vocab_indices(
    num_words: int,
    phones_per_word: Tuple[int, int],
    num_phones: int,
    seed: int,
) -> Dict[str, Tuple[int, ...]]:
    """label -> phone-INDEX tuple: the one seeded draw both the acoustic
    vocabulary (make_vocabulary) and the pronunciation lexicon
    (make_lexicon) are derived from, so they always agree."""
    rng = np.random.default_rng(seed + 1)
    labels = word_labels(num_words)
    lo, hi = phones_per_word
    capacity = sum(num_phones ** n for n in range(lo, hi + 1))
    if num_words > capacity // 2:
        # Half-full keeps rejection sampling fast AND leaves headroom; the
        # analogous label-space overflow raises in word_labels.
        raise ValueError(
            f"{num_words} unique pronunciations from {num_phones} phones x "
            f"{lo}-{hi} slots ({capacity} possible) — enlarge the "
            "inventory or the word length range"
        )
    seen = set()
    out: Dict[str, Tuple[int, ...]] = {}
    for label in labels:
        while True:
            n = int(rng.integers(lo, hi + 1))
            idx = tuple(int(i) for i in rng.integers(0, num_phones, size=n))
            if idx not in seen:
                seen.add(idx)
                break
        out[label] = idx
    return out


def phone_name(index: int) -> str:
    return f"p{index:02d}"


def make_vocabulary(
    num_words: int = 100,
    phones_per_word: Tuple[int, int] = (3, 5),
    num_phones: int = 24,
    seed: int = 7,
) -> Dict[str, tuple]:
    """label -> phone-template tuple, the SyntheticTIDigits.phone_templates
    format. Words are unique phone sequences of phones_per_word[0]..[1]
    phones drawn from one shared inventory. Longer words (default 3-5
    phones vs the digits' fixed 3) keep whole-word collision probability
    low even when individual phones are shared."""
    inventory = make_phone_inventory(num_phones, seed)
    indices = _vocab_indices(num_words, phones_per_word, num_phones, seed)
    return {
        label: tuple(inventory[i] for i in idx)
        for label, idx in indices.items()
    }


def make_lexicon(
    num_words: int = 100,
    phones_per_word: Tuple[int, int] = (3, 5),
    num_phones: int = 24,
    seed: int = 7,
):
    """The GENERATION-TRUTH pronunciation lexicon of make_word_corpus:
    word label -> tuple of phone names ("p00".."pNN"), drawn from the same
    seeded sequence as make_vocabulary — what a real system gets from a
    pronunciation dictionary, here known exactly by construction. Feeds the
    tied phone tier (models/lexicon.py)."""
    from ..models.lexicon import Lexicon

    indices = _vocab_indices(num_words, phones_per_word, num_phones, seed)
    return Lexicon({
        label: tuple(phone_name(i) for i in idx)
        for label, idx in indices.items()
    })


def make_word_corpus(
    num_words: int = 100,
    hard: bool = False,
    phones_per_word: Tuple[int, int] = (3, 5),
    num_phones: int = 24,
    vocab_seed: int = 7,
    **corpus_kwargs,
) -> SyntheticTIDigits:
    """A SyntheticTIDigits corpus over a generated num_words vocabulary.

    Same knobs and splits as the digit corpus (speakers, takes, sentences,
    SNR/channel hardening); transcripts of multi-word sentences are label
    tuples. hard=True applies the calibrated hardened-corpus degradations.
    """
    vocab = make_vocabulary(num_words, phones_per_word, num_phones, vocab_seed)
    maker = SyntheticTIDigits.hard if hard else SyntheticTIDigits
    return maker(phone_templates=vocab, **corpus_kwargs)
