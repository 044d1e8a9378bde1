"""Left-context biphones: the context-dependent rung of the phone tier (a
port of cs304_tpu/models/biphone.py; training and smoothing run on
``device``, the first card by default).

The monophone tier (`models/lexicon.py`) ties every occurrence of a phone
to ONE model, which ignores coarticulation: the same phone sounds
different after different neighbors. The classical next rung is
context-dependent units. This module adds LEFT-CONTEXT BIPHONES as a pure
*relabeling* on top of the existing machinery — no new trainer, decoder,
or topology code:

  - a biphone unit is the string ``f"{prev}-{cur}"`` (phone names carry no
    ``-``); the word-initial context is the silence label ``S``, which is
    literally what precedes a word in this framework (the trainer
    interleaves silence between words, reference
    hidden_markov_model.py:794-797) — so every word's unit sequence is
    CONTEXT-CLOSED: independent of its sentence neighbors, which keeps
    compose-on-demand decoding and OOV words working;
  - ``biphone_lexicon`` derives a word -> biphone-unit lexicon from the
    pronunciation lexicon, after which `train_phone_models` trains the
    units UNCHANGED (they are just labels to the embedded trainer);
  - units initialize as CLONES of the trained monophones (the standard
    context-dependent init) — before any training the tiers are
    numerically identical, which the tests pin down;
  - at compose time, units the training data never saw BACK OFF to their
    monophone — a new word made of known phones still decodes (the OOV
    guarantee survives context dependence).

There is no reference equivalent (the reference is word-level only); the
monophone tier this builds on is cited at models/lexicon.py.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np

from .hmm import WordHMM
from .lexicon import Lexicon, SILENCE_LABEL, compose_word_models


def biphone_label(prev: str, cur: str) -> str:
    """Unit name for phone `cur` with left context `prev`."""
    if "-" in cur:
        raise ValueError(f"phone name {cur!r} may not contain '-'")
    return f"{prev}-{cur}"


def split_biphone(unit: str) -> Tuple[str, str]:
    """Inverse of `biphone_label` (the context itself never contains '-')."""
    prev, _, cur = unit.partition("-")
    if not cur:
        raise ValueError(f"{unit!r} is not a biphone unit")
    return prev, cur


def word_units(phones: Sequence[str]) -> Tuple[str, ...]:
    """A word's pronunciation -> its left-context biphone unit sequence;
    the first phone's context is silence (see module docstring)."""
    prev = SILENCE_LABEL
    out: List[str] = []
    for p in phones:
        out.append(biphone_label(prev, p))
        prev = p
    return tuple(out)


def biphone_lexicon(
    lexicon: Lexicon, words: Iterable[str] | None = None
) -> Lexicon:
    """Derive the word -> biphone-unit lexicon. Everything downstream
    (training expansion, composition) runs on this derived lexicon with
    the unit models standing in for phones."""
    names = lexicon.words if words is None else list(words)
    return Lexicon({w: word_units(lexicon[w]) for w in names})


def observed_units(
    lexicon: Lexicon, words: Iterable[str] | None = None
) -> Set[str]:
    names = lexicon.words if words is None else list(words)
    units: Set[str] = set()
    for w in names:
        units.update(word_units(lexicon[w]))
    return units


def clone_unit_models(
    monophones: Dict[str, WordHMM],
    units: Iterable[str],
    center_of_unit,
    kind: str,
) -> Dict[str, WordHMM]:
    """Shared context-dependent initialization for every unit tier: each
    unit starts as a copy of its center monophone (`center_of_unit` maps a
    unit label to its phone), so an untrained tier is numerically the
    monophone tier; training then lets the contexts diverge."""
    out: Dict[str, WordHMM] = {}
    for unit in sorted(set(units)):
        cur = center_of_unit(unit)
        if cur not in monophones:
            raise ValueError(f"unit {unit!r} needs untrained phone {cur!r}")
        m = monophones[cur]
        if hasattr(m, "weights"):
            raise ValueError(
                f"{kind} units initialize from K=1 monophones; train the "
                "monophone stage without gmm_mixtures and pass "
                f"gmm_mixtures to the {kind} stage instead"
            )
        out[unit] = WordHMM(
            label=unit,
            means=np.array(m.means, copy=True),
            covariances=np.array(m.covariances, copy=True),
            log_a=np.array(m.log_a, copy=True),
        )
    return out


def clone_biphone_models(
    monophones: Dict[str, WordHMM], units: Iterable[str]
) -> Dict[str, WordHMM]:
    return clone_unit_models(
        monophones, units, lambda u: split_biphone(u)[1], "biphone"
    )


def prefer_silence(table: Dict[str, WordHMM], *sources) -> None:
    """Install the silence model from the most context-dependent source
    that has one (the unit stage re-estimates silence alongside its
    units, so its version matches the units' alignment)."""
    for src in sources:
        if src and SILENCE_LABEL in src:
            table[SILENCE_LABEL] = src[SILENCE_LABEL]
            return


def train_unit_models(
    monophones: Dict[str, WordHMM],
    labeled_features: Dict[object, Sequence[np.ndarray]],
    lexicon: Lexicon,
    unit_lexicon_fn,
    clone_fn,
    kind: str,
    config=None,
    mesh=None,
    gmm_mixtures: int = 0,
    smooth_tau: float | None = None,
    device=None,
) -> Tuple[Dict[str, WordHMM], int]:
    """Shared training body for every context-dependent tier: derive the
    unit lexicon, clone the observed units from the monophones, then
    either full embedded re-estimation (the unchanged trainer) or one
    MAP-smoothing pass (`smooth_tau`)."""
    from .lexicon import train_phone_models

    train_words: Set[str] = set()
    for tr in labeled_features:
        # str transcripts iterate per character, matching
        # Lexicon.expand_transcript's digit-string convention.
        train_words.update(list(tr) if isinstance(tr, str) else tr)
    missing = sorted(w for w in train_words if w not in lexicon)
    if missing:
        raise ValueError(f"transcript words missing from lexicon: {missing}")
    unit_lex = unit_lexicon_fn(lexicon)
    units = {u for w in sorted(train_words) for u in unit_lex[w]}
    clones = clone_fn(monophones, units)
    if SILENCE_LABEL not in monophones:
        raise ValueError("monophones must include the silence model 'S'")
    clones[SILENCE_LABEL] = monophones[SILENCE_LABEL]
    if smooth_tau is not None:
        if gmm_mixtures > 1:
            raise ValueError(
                "smooth_tau is a K=1 MAP pass; refine with gmm_mixtures "
                "via full re-estimation instead"
            )
        from .adapt import map_adapt

        expanded = {
            unit_lex.expand_transcript(tr): feats
            for tr, feats in labeled_features.items()
        }
        if len(expanded) != len(labeled_features):
            # Same guard train_phone_models applies: merging homophones
            # silently would drop all but one transcript's utterances.
            raise ValueError(
                f"two transcripts expanded to the same {kind} sequence — "
                "merge their utterance lists first"
            )
        return map_adapt(clones, expanded, tau=smooth_tau,
                         insert_sil=False, device=device), 1
    return train_phone_models(
        clones, labeled_features, unit_lex,
        config=config, mesh=mesh, gmm_mixtures=gmm_mixtures, device=device,
    )


def backoff_table(
    biphone_models: Dict[str, WordHMM],
    monophones: Dict[str, WordHMM],
    units: Iterable[str],
) -> Tuple[Dict[str, WordHMM], int]:
    """unit -> model, backing off to the monophone for unseen units.
    Returns (table, number of backed-off units)."""
    table: Dict[str, WordHMM] = {}
    backed_off = 0
    for unit in sorted(set(units)):
        if unit in biphone_models:
            table[unit] = biphone_models[unit]
        else:
            _, cur = split_biphone(unit)
            if cur not in monophones:
                raise ValueError(
                    f"unit {unit!r}: no trained biphone and no monophone "
                    f"{cur!r} to back off to"
                )
            table[unit] = monophones[cur]
            backed_off += 1
    return table, backed_off


def train_biphone_models(
    monophones: Dict[str, WordHMM],
    labeled_features: Dict[object, Sequence[np.ndarray]],
    lexicon: Lexicon,
    config=None,
    mesh=None,
    gmm_mixtures: int = 0,
    smooth_tau: float | None = None,
    device=None,
) -> Tuple[Dict[str, WordHMM], int]:
    """Embedded training of the biphone units observed in the training
    words, initialized from the trained monophones. `labeled_features`
    maps WORD transcripts to utterances, exactly as for
    `train_phone_models`: a tuple of word labels, or a digit-string style
    str that iterates as one word PER CHARACTER (multi-char word labels
    must use tuples) — the derived biphone lexicon handles the
    relabeling. Returns (unit models incl. silence, K=1 iterations).

    smooth_tau: MAP-smoothed units instead of full re-estimation — the
    monophone clone is the prior and one forced-alignment pass
    interpolates each unit's means toward its aligned frames
    (`models/adapt.py`: mu' = (tau*mu0 + sum_x)/(tau + count)). Rare
    units stay near the monophone, frequent units move to their context
    acoustics — the data-sparsity answer measured in ROADMAP.md (untied
    units lose to monophones on sparse corpora, win at 4x data; smoothing
    interpolates between the regimes by unit occupancy)."""
    return train_unit_models(
        monophones, labeled_features, lexicon,
        biphone_lexicon, clone_biphone_models, "biphone",
        config=config, mesh=mesh, gmm_mixtures=gmm_mixtures,
        smooth_tau=smooth_tau, device=device,
    )


def compose_word_models_biphone(
    lexicon: Lexicon,
    biphone_models: Dict[str, WordHMM],
    monophones: Dict[str, WordHMM],
    words: Sequence[str] | None = None,
) -> Dict[str, WordHMM]:
    """Per-word HMMs from biphone units with monophone back-off; the
    concatenation itself (block-diag transitions, free exit->entry, GMM
    lifting, silence passthrough) is `compose_word_models` on the derived
    lexicon."""
    names = lexicon.words if words is None else list(words)
    blex = biphone_lexicon(lexicon, names)
    units = {u for seq in blex.entries.values() for u in seq}
    table, _ = backoff_table(biphone_models, monophones, units)
    prefer_silence(table, biphone_models, monophones)
    return compose_word_models(blex, table, names)


def _unit_tier_of(folder: str) -> str | None:
    """A unit directory's tier: the manifest's self-describing
    ``unit_tier`` field (checkpoints written since round 4), falling back
    to the directory-name convention for older checkpoints."""
    import os

    from ..utils.checkpoint import load_manifest

    tier = load_manifest(folder).get("unit_tier")
    if tier:
        return tier
    name = os.path.basename(os.path.normpath(folder))
    return name if name in ("senones", "triphones", "biphones") else None


def load_unit_table(
    lexicon_path: str, monophones: Dict[str, WordHMM],
    unseen_senones: str = "backoff",
) -> Tuple[Lexicon, Lexicon | None, Dict[str, WordHMM] | None, str]:
    """Detect and load a phone checkpoint's context-dependent units — THE
    one place that knows the on-disk convention; `compose_from_checkpoint`
    (transcribe) and align.py both route through it. Unit directories
    live next to the lexicon JSON (written by ``train_phones.py
    --biphones/--triphones/--senones``) and SELF-DESCRIBE their tier via
    the manifest's ``unit_tier`` field (utils/checkpoint.py:save_models);
    manifest-less directories fall back to the historical name probe
    (senones/ triphones/ biphones/), so old checkpoints still load.

    Returns (lexicon, unit_lexicon, unit_table, description):
    (lex, None, None, "") for a plain monophone checkpoint; otherwise the
    derived unit lexicon (biphone or triphone) and a table mapping every
    unit of the full lexicon to a model through the back-off chain
    (senones -> triphone -> biphone when present -> monophone), plus the
    silence model (preferring the most context-dependent stage's). The
    senone tier wins over every other; its unseen triphones back off to
    monophones per ``unseen_senones`` ("backoff", the measured round-4
    default — see senone_unit_table) or synthesize through the decision
    trees ("synthesize"). (The self-contained ``tied_triphones`` tier is
    NOT dispatched here — a tied checkpoint is decoded via its OWN
    lexicon.json as plain units.)"""
    import os

    from ..utils.checkpoint import load_models

    lexicon = Lexicon.load(lexicon_path)
    root = os.path.dirname(os.path.abspath(lexicon_path))
    tier_dirs: Dict[str, str] = {}
    for name in sorted(os.listdir(root)):
        sub = os.path.join(root, name)
        if not os.path.isdir(sub):
            continue
        tier = _unit_tier_of(sub)
        if tier is not None:
            tier_dirs.setdefault(tier, sub)

    if "senones" in tier_dirs:
        from .senone import SenoneTying, senone_unit_table
        from .triphone import triphone_lexicon

        sdir = tier_dirs["senones"]
        unit_models = load_models(sdir)
        tying = SenoneTying.load(os.path.join(sdir, "senone_tying.json"))
        table, materialized = senone_unit_table(
            lexicon, unit_models, tying, monophones, unseen=unseen_senones
        )
        how = ("synthesized from trees" if unseen_senones == "synthesize"
               else "backed off to monophones")
        n = sum(1 for u in unit_models if u != SILENCE_LABEL)
        desc = (f"{n} senone-tied triphone units / "
                f"{tying.num_senones()} senones "
                f"({materialized} unseen units {how})")
        return lexicon, triphone_lexicon(lexicon), table, desc
    bi_models = (
        load_models(tier_dirs["biphones"])
        if "biphones" in tier_dirs else None
    )
    if "triphones" in tier_dirs:
        from .triphone import (
            backoff_table_tri,
            observed_units_tri,
            triphone_lexicon,
        )

        tri_models = load_models(tier_dirs["triphones"])
        n = sum(1 for u in tri_models if u != SILENCE_LABEL)
        table, to_bi, to_mono = backoff_table_tri(
            tri_models, bi_models or {}, monophones,
            observed_units_tri(lexicon),
        )
        prefer_silence(table, tri_models, monophones)
        desc = (f"{n} triphone units ({to_bi} backed off to biphones, "
                f"{to_mono} to monophones)")
        return lexicon, triphone_lexicon(lexicon), table, desc
    if bi_models is not None:
        n = sum(1 for u in bi_models if u != SILENCE_LABEL)
        table, backed = backoff_table(
            bi_models, monophones, observed_units(lexicon)
        )
        prefer_silence(table, bi_models, monophones)
        desc = f"{n} biphone units ({backed} backed off to monophones)"
        return lexicon, biphone_lexicon(lexicon), table, desc
    return lexicon, None, None, ""


def compose_from_checkpoint(
    lexicon_path: str, monophones: Dict[str, WordHMM]
) -> Tuple[Lexicon, Dict[str, WordHMM], str]:
    """Compose word models from a phone checkpoint, context-dependence-
    aware (see `load_unit_table` for the detection convention). Returns
    (lexicon, word models, unit-tier description — "" for monophones)."""
    lexicon, unit_lex, table, desc = load_unit_table(
        lexicon_path, monophones
    )
    if table is None:
        return lexicon, compose_word_models(lexicon, monophones), ""
    return lexicon, compose_word_models(unit_lex, table), desc
