"""Triphones: both-side context-dependent phone units with a back-off
chain (a port of cs304_tpu/models/triphone.py; training runs on
``device``, the first card by default).

`models/biphone.py` models the LEFT neighbor; real coarticulation is
bidirectional (a phone's offset anticipates the next phone as much as its
onset carries the previous one). A triphone unit is the string
``f"{prev}-{cur}+{next}"`` — word-initial ``prev`` and word-final ``next``
are the silence label, so every word's unit sequence stays CONTEXT-CLOSED
(independent of sentence neighbors), preserving compose-on-demand
decoding and OOV words exactly as in the biphone tier.

Everything is the same relabeling trick over the unchanged embedded
trainer; what triphones add is the classical BACK-OFF CHAIN for the much
sparser unit space: a word's unit resolves to the trained triphone, else
the trained left-biphone ``prev-cur``, else the monophone — so a tier
trained with any coverage still composes every lexicon word. MAP
smoothing (`smooth_tau`) applies unchanged and matters more here (unit
counts grow ~quadratically in inventory contexts).

No reference equivalent (the reference is word-level only); builds on
models/lexicon.py and models/biphone.py.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple

from .biphone import biphone_label
from .hmm import WordHMM
from .lexicon import Lexicon, SILENCE_LABEL, compose_word_models


def triphone_label(prev: str, cur: str, nxt: str) -> str:
    if "-" in cur or "+" in cur:
        raise ValueError(f"phone name {cur!r} may not contain '-' or '+'")
    return f"{prev}-{cur}+{nxt}"


def split_triphone(unit: str) -> Tuple[str, str, str]:
    """Inverse of `triphone_label` (contexts never contain '-'/'+')."""
    prev, _, rest = unit.partition("-")
    cur, sep, nxt = rest.partition("+")
    if not rest or not sep or not cur:
        raise ValueError(f"{unit!r} is not a triphone unit")
    return prev, cur, nxt


def word_units_tri(phones: Sequence[str]) -> Tuple[str, ...]:
    """A pronunciation -> its triphone unit sequence; silence stands in
    for the missing contexts at both word edges."""
    out: List[str] = []
    for i, p in enumerate(phones):
        prev = phones[i - 1] if i > 0 else SILENCE_LABEL
        nxt = phones[i + 1] if i + 1 < len(phones) else SILENCE_LABEL
        out.append(triphone_label(prev, p, nxt))
    return tuple(out)


def triphone_lexicon(
    lexicon: Lexicon, words: Iterable[str] | None = None
) -> Lexicon:
    names = lexicon.words if words is None else list(words)
    return Lexicon({w: word_units_tri(lexicon[w]) for w in names})


def observed_units_tri(
    lexicon: Lexicon, words: Iterable[str] | None = None
) -> Set[str]:
    names = lexicon.words if words is None else list(words)
    units: Set[str] = set()
    for w in names:
        units.update(word_units_tri(lexicon[w]))
    return units


def clone_triphone_models(
    monophones: Dict[str, WordHMM], units: Iterable[str]
) -> Dict[str, WordHMM]:
    """Context-dependent init: each triphone starts as a copy of its
    center monophone (same contract as the biphone clones)."""
    from .biphone import clone_unit_models

    return clone_unit_models(
        monophones, units, lambda u: split_triphone(u)[1], "triphone"
    )


def backoff_table_tri(
    triphone_models: Dict[str, WordHMM],
    biphone_models: Dict[str, WordHMM],
    monophones: Dict[str, WordHMM],
    units: Iterable[str],
) -> Tuple[Dict[str, WordHMM], int, int]:
    """unit -> model through the chain triphone -> left-biphone ->
    monophone. Returns (table, biphone_backoffs, monophone_backoffs).
    Pass {} for biphone_models to skip that rung."""
    table: Dict[str, WordHMM] = {}
    to_bi = 0
    to_mono = 0
    for unit in sorted(set(units)):
        if unit in triphone_models:
            table[unit] = triphone_models[unit]
            continue
        prev, cur, _ = split_triphone(unit)
        bi = biphone_label(prev, cur)
        if bi in biphone_models:
            table[unit] = biphone_models[bi]
            to_bi += 1
        elif cur in monophones:
            table[unit] = monophones[cur]
            to_mono += 1
        else:
            raise ValueError(
                f"unit {unit!r}: no triphone, no biphone {bi!r}, and no "
                f"monophone {cur!r} to back off to"
            )
    return table, to_bi, to_mono


def train_triphone_models(
    monophones: Dict[str, WordHMM],
    labeled_features: Dict[object, Sequence["np.ndarray"]],
    lexicon: Lexicon,
    config=None,
    mesh=None,
    gmm_mixtures: int = 0,
    smooth_tau: float | None = None,
    device=None,
) -> Tuple[Dict[str, WordHMM], int]:
    """Embedded training of the triphone units observed in the training
    words (same transcript conventions as `train_biphone_models`:
    tuples of word labels, or per-character digit strings). smooth_tau
    swaps full re-estimation for one MAP pass against the monophone-clone
    priors — the recommended mode for triphones, whose per-unit data is
    sparsest. Returns (unit models incl. silence, K=1 iterations)."""
    from .biphone import train_unit_models

    return train_unit_models(
        monophones, labeled_features, lexicon,
        triphone_lexicon, clone_triphone_models, "triphone",
        config=config, mesh=mesh, gmm_mixtures=gmm_mixtures,
        smooth_tau=smooth_tau, device=device,
    )


def cluster_triphone_units(
    unit_models: Dict[str, WordHMM], max_per_phone: int
) -> Dict[str, str]:
    """Data-driven unit tying (generalized triphones, Lee 1990): within
    each center phone, agglomeratively merge the acoustically closest
    triphone units (Euclidean distance between stacked state means) until
    at most `max_per_phone` clusters remain. Returns unit -> cluster
    label ("<phone>~<k>"); silence and non-triphone labels are skipped.

    This is MODEL-level tying — the answer to triphone data sparsity
    that back-off only postpones: similar contexts SHARE one model and
    pool their statistics when retrained (`tie_and_train_triphones`)."""
    import numpy as np

    if max_per_phone < 1:
        raise ValueError(f"max_per_phone must be >= 1, got {max_per_phone}")
    by_phone: Dict[str, List[str]] = {}
    for unit in unit_models:
        if unit == SILENCE_LABEL:
            continue
        _, cur, _ = split_triphone(unit)
        by_phone.setdefault(cur, []).append(unit)
    mapping: Dict[str, str] = {}
    for phone, units in sorted(by_phone.items()):
        units = sorted(units)
        clusters: List[List[str]] = [[u] for u in units]

        def centroid(cluster):
            return np.mean(
                [np.asarray(unit_models[u].means).ravel() for u in cluster],
                axis=0,
            )

        while len(clusters) > max_per_phone:
            cents = [centroid(c) for c in clusters]
            best = None
            for i in range(len(clusters)):
                for j in range(i + 1, len(clusters)):
                    d = float(np.linalg.norm(cents[i] - cents[j]))
                    if best is None or d < best[0]:
                        best = (d, i, j)
            _, i, j = best
            clusters[i] = clusters[i] + clusters[j]
            del clusters[j]
        for k, cluster in enumerate(clusters):
            for u in cluster:
                mapping[u] = f"{phone}~{k}"
    return mapping


def tie_and_train_triphones(
    monophones: Dict[str, WordHMM],
    labeled_features: Dict[object, Sequence["np.ndarray"]],
    lexicon: Lexicon,
    max_per_phone: int = 4,
    config=None,
    mesh=None,
    seed_smooth_tau: float = 30.0,
    device=None,
) -> Tuple[Dict[str, WordHMM], Lexicon, Dict[str, str]]:
    """Generalized-triphone training: (1) a cheap MAP-smoothed seed pass
    estimates every observed unit's acoustics, (2) units cluster per
    center phone, (3) the TIED models retrain through the unchanged
    embedded trainer — each word's transcript expands to CLUSTER labels,
    so cluster members pool statistics by construction (the same
    relabeling trick as every other tier).

    Returns (tied models incl. silence, tied word->cluster-label lexicon
    covering the FULL input lexicon, unit->cluster mapping). Words whose
    units were never seen in training fall back to their center
    monophone's label inside the tied lexicon (the monophone model is
    included in the returned dict), preserving OOV decoding."""
    seed_units, _ = train_triphone_models(
        monophones, labeled_features, lexicon, smooth_tau=seed_smooth_tau,
        device=device,
    )
    mapping = cluster_triphone_units(seed_units, max_per_phone)

    def tied_label(unit: str) -> str:
        if unit in mapping:
            return mapping[unit]
        # OOV back-off: unseen context uses the center monophone.
        return split_triphone(unit)[1]

    tied_entries = {
        w: tuple(tied_label(u) for u in word_units_tri(lexicon[w]))
        for w in lexicon.words
    }
    tied_lex = Lexicon(tied_entries)

    from .biphone import clone_unit_models

    train_words: Set[str] = set()
    for tr in labeled_features:
        train_words.update(list(tr) if isinstance(tr, str) else tr)
    needed = {l for w in sorted(train_words) for l in tied_entries[w]}
    clones = clone_unit_models(
        monophones, {l for l in needed if "~" in l},
        lambda lab: lab.split("~", 1)[0], "tied-triphone",
    )
    for lab in needed - set(clones):  # monophone back-off labels
        clones[lab] = monophones[lab]
    clones[SILENCE_LABEL] = monophones[SILENCE_LABEL]

    from .lexicon import train_phone_models

    trained, _ = train_phone_models(
        clones, labeled_features,
        Lexicon({w: tied_entries[w] for w in sorted(train_words)}),
        config=config, mesh=mesh, device=device,
    )
    # Models for labels the training data never reached (OOV-only
    # back-off monophones) come from the monophone inventory.
    out = dict(trained)
    for w in lexicon.words:
        for lab in tied_entries[w]:
            if lab not in out:
                out[lab] = monophones[lab]
    return out, tied_lex, mapping


def compose_word_models_triphone(
    lexicon: Lexicon,
    triphone_models: Dict[str, WordHMM],
    monophones: Dict[str, WordHMM],
    biphone_models: Dict[str, WordHMM] | None = None,
    words: Sequence[str] | None = None,
) -> Dict[str, WordHMM]:
    """Per-word HMMs from triphone units through the back-off chain
    (triphone -> left-biphone when supplied -> monophone)."""
    names = lexicon.words if words is None else list(words)
    tlex = triphone_lexicon(lexicon, names)
    units = {u for seq in tlex.entries.values() for u in seq}
    table, _, _ = backoff_table_tri(
        triphone_models, biphone_models or {}, monophones, units
    )
    from .biphone import prefer_silence

    prefer_silence(table, triphone_models, monophones)
    return compose_word_models(tlex, table, names)
