"""Lattice-level LM rescoring and confusion networks.

The port of the JAX package's ops/rescore.py, the second pass of the decoder
stack on top of ops/lattice.py:

- ``arc_acoustic_scores``: exact arc-local acoustic scores, the within-word
  Viterbi score of word w emitting frames [start, end) (entered at its entry
  state, left from its exit, the entry self-loop applied only at frame 0),
  for every arc at once: each arc a row of the sentence trellis K3
  (ops/cuda/trellis_banded.py:banded_forward, its plain version on a CPU
  tensor) over its (max_span, s_max) window, one launch for all arcs, on
  the device the caller names. Summing arc scores along a segmentation of a
  state path plus one penalty a boundary gives the dense Viterbi path
  score.
- ``lattice_rescore`` / ``lattice_rescore_trigram``: exact best path
  through a lattice under acoustic + lm_weight * log P(w | history) +
  penalty per word edge, a host DP over (node, history).
- ``confusion_network`` / ``cn_decode``: pivot "sausage" decoding on the
  1-best word spans (the dense decode without the quirk) and the forward
  lattice's word-end posteriors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cuda.trellis_banded import banded_forward
from .lattice import Lattice, LatticeArc, path_word_spans
from .nbest import emissions_of
from .viterbi import banded_diagonals

__all__ = [
    "arc_acoustic_scores", "lattice_rescore", "lattice_rescore_trigram",
    "exhaustive_lattice", "ConfusionSlot", "confusion_network", "cn_decode",
]


def arc_acoustic_scores(composite, arcs: Sequence[LatticeArc], log_b=None,
                        features=None, skip: int = 2, device=None) -> np.ndarray:
    """(len(arcs),) exact arc-local acoustic scores (module docstring).

    log_b: (T, S) emissions (composite.log_likelihoods(features) when None;
    GMM densities on a GMM checkpoint). Spans pad to a 32-frame bucket.

    Each arc is one K3 row: its window of log_b (max_span frames from its
    start, s_max states from its word's entry), the self / prev / skip
    diagonals of its word's (s_max, s_max) block masked to the band, its
    span as the row's length, and a t = 0 seed of the entry self-loop where
    the arc starts the utterance (0 elsewhere, -inf counting as 0); the
    score is alpha at the word's exit. K3 takes skip 0, 1 or 2 (c2, and c1
    at 0, -inf); any other skip raises ValueError, on every device."""
    if not 0 <= skip <= 2:
        raise ValueError(f"skip={skip}: the arc scores' kernel (K3) takes skip 0, 1 or 2")
    if not arcs:
        return np.zeros((0,), np.float32)
    log_b, dev = emissions_of(composite, features, log_b, device)
    t_total, s_total = log_b.shape
    word_index = {l: w for w, l in enumerate(composite.labels)}
    lowers_w = np.asarray(composite.lowers)
    uppers_w = np.asarray(composite.uppers)
    diag = np.diagonal(np.asarray(composite.log_a)).copy()
    diag[~np.isfinite(diag)] = 0.0

    ws = np.asarray([word_index[a.label] for a in arcs], np.int64)
    starts = np.asarray([a.start for a in arcs], np.int64)
    spans = np.asarray([a.end - a.start for a in arcs], np.int64)
    lowers = lowers_w[ws].astype(np.int64)
    s_ws = (uppers_w[ws] - lowers_w[ws] + 1).astype(np.int64)
    # The entry self-loop applies only where the utterance starts in this
    # arc; a cross-word hop carries no self-loop term.
    entry_diag = np.where(starts == 0, diag[lowers], 0.0).astype(np.float32)
    s_max = int(max(composite.state_counts))
    max_span = -(-int(spans.max()) // 32) * 32

    # Padded so every arc's window lies inside (values past a span or a
    # word's states are masked below).
    log_b_pad = torch.zeros((t_total + max_span, s_total + s_max), device=dev)
    log_b_pad[:t_total, :s_total] = log_b
    log_a_pad = torch.full((s_total + s_max, s_total + s_max), float("-inf"), device=dev)
    log_a_pad[:s_total, :s_total] = torch.as_tensor(composite.log_a, device=dev)
    starts_d, lowers_d, s_ws_d = (torch.as_tensor(x, device=dev)
                                  for x in (starts, lowers, s_ws))
    frames = starts_d[:, None] + torch.arange(max_span, device=dev)   # (N, M)
    states = lowers_d[:, None] + torch.arange(s_max, device=dev)      # (N, s_max)
    lb = log_b_pad[frames[:, :, None], states[:, None, :]]            # (N, M, s_max)
    la = log_a_pad[states[:, :, None], states[:, None, :]]            # (N, s_max, s_max)
    frm = torch.arange(s_max, device=dev)[:, None]
    to = torch.arange(s_max, device=dev)[None, :]
    sw = s_ws_d[:, None, None]
    band = (frm <= to) & (frm >= to - skip) & (to < sw) & (frm < sw)
    trans = torch.where(band, la, float("-inf"))
    rows = torch.arange(len(arcs), device=dev)
    spans_d = torch.as_tensor(spans, dtype=torch.int32, device=dev)
    seed = torch.as_tensor(entry_diag, device=dev)
    c0, c1, c2 = banded_diagonals(trans, len(arcs))
    alpha, _bp = banded_forward(lb.contiguous(), c0, c1, c2, spans_d, seed)
    return alpha[rows, s_ws_d - 1].cpu().numpy()


def lattice_rescore(composite, lattice: Lattice, log_b=None, features=None,
                    bigram=None, lm_weight: float = 1.0,
                    penalty: float | None = None, boundaries: bool = False,
                    skip_silence: bool = True, device=None,
                    ) -> Tuple[float, str, List[LatticeArc]]:
    """Exact best path through the lattice under the rescored measure.

    Path score = sum of arc-local acoustics + per-edge
    lm_weight * log P(w | w') + penalty (ops/lm.word_pair_penalties — the
    identical matrix the first-pass bigram decoder uses, so words outside the
    LM vocabulary fall back to the flat penalty). bigram=None rescores under
    the flat penalty alone (useful to sweep `penalty` per-lattice without
    re-decoding). boundaries=True additionally applies the LM's <s>/<\\s>
    terms (as rescore_nbest does); the default matches the first-pass
    decoder, which has no boundary terms.

    Returns (score, text, arcs_on_best_path); text skips silence arcs like
    path_to_labels. Raises ValueError when no arc chain spans the utterance.
    """
    from .lm import word_pair_penalties

    if penalty is None:
        penalty = composite.penalty
    w_total = len(composite.labels)
    if bigram is not None:
        pair = word_pair_penalties(composite, bigram, lm_weight, penalty)
        lm_idx = {l: i for i, l in enumerate(bigram.labels)}
    else:
        pair = np.full((w_total, w_total), penalty, np.float32)
        lm_idx = {}
    word_index = {l: w for w, l in enumerate(composite.labels)}

    arcs = lattice.sorted_arcs()
    acoustic = arc_acoustic_scores(
        composite, arcs, log_b=log_b, features=features, device=device
    )
    by_start: Dict[int, List[int]] = {}
    for i, a in enumerate(arcs):
        by_start.setdefault(a.start, []).append(i)

    # DP over (frame node, previous word); -1 = utterance start.
    best: Dict[Tuple[int, int], float] = {(0, -1): 0.0}
    back: Dict[Tuple[int, int], Tuple[Tuple[int, int], int]] = {}
    for f in sorted({0} | {a.start for a in arcs}):
        for i in by_start.get(f, []):
            a = arcs[i]
            w = word_index[a.label]
            for c in range(-1, w_total):
                src = (f, c)
                base = best.get(src)
                if base is None:
                    continue
                edge = float(acoustic[i])
                if c >= 0:
                    edge += float(pair[c, w])
                elif boundaries and bigram is not None \
                        and a.label in lm_idx:
                    edge += lm_weight * float(
                        bigram.log_p_init[lm_idx[a.label]]
                    )
                dst = (a.end, w)
                sc = base + edge
                if sc > best.get(dst, -np.inf):
                    best[dst] = sc
                    back[dst] = (src, i)

    finals = []
    for c in range(w_total):
        node = (lattice.num_frames, c)
        sc = best.get(node)
        if sc is None:
            continue
        if boundaries and bigram is not None \
                and composite.labels[c] in lm_idx:
            sc += lm_weight * float(
                bigram.log_p_final[lm_idx[composite.labels[c]]]
            )
        finals.append((sc, node))
    if not finals:
        raise ValueError(
            "no arc chain spans the lattice (disconnected — widen the beam)"
        )
    score, node = max(finals, key=lambda sn: sn[0])
    path_arcs: List[LatticeArc] = []
    while node in back:
        node, i = back[node]
        path_arcs.append(arcs[i])
    path_arcs.reverse()
    text = "".join(
        a.label for a in path_arcs
        if not (skip_silence and a.label == lattice.silence_label)
    )
    return float(score), text, path_arcs


def lattice_rescore_trigram(composite, lattice: Lattice, trigram,
                            log_b=None, features=None,
                            lm_weight: float = 1.0,
                            penalty: float | None = None,
                            boundaries: bool = False,
                            skip_silence: bool = True, device=None,
                            ) -> Tuple[float, str, List[LatticeArc]]:
    """Exact best lattice path under a TRIGRAM measure (ops/lm.WordTrigram).

    Same contract as lattice_rescore, but the DP state carries TWO words of
    history — (frame node, w'', w') — so each edge scores
    acoustic + lm_weight * log P(w | w'', w') + penalty. First-pass
    decoding stays bigram (the trellis carries one word of context); this
    is the standard second pass that recovers the longer context. Arc
    labels outside the trigram vocabulary contribute the flat penalty
    alone and a boundary history slot (the same closed-vocabulary fallback
    the bigram pair matrix uses). boundaries=True adds the <s>-initial and
    </s>-final terms.
    """
    if penalty is None:
        penalty = composite.penalty
    lm_idx = trigram.index
    bnd = trigram.boundary

    arcs = lattice.sorted_arcs()
    acoustic = arc_acoustic_scores(
        composite, arcs, log_b=log_b, features=features, device=device
    )
    by_start: Dict[int, List[int]] = {}
    for i, a in enumerate(arcs):
        by_start.setdefault(a.start, []).append(i)

    # DP over (frame node, lm-history pair); bnd = sentence boundary / OOV.
    start_hist = (bnd, bnd)
    best: Dict[Tuple[int, int, int], float] = {(0, *start_hist): 0.0}
    back: Dict[Tuple[int, int, int],
               Tuple[Tuple[int, int, int], int]] = {}
    frames = sorted({0} | {a.start for a in arcs})
    states_at: Dict[int, set] = {0: {start_hist}}
    for f in frames:
        for i in by_start.get(f, []):
            a = arcs[i]
            w = lm_idx.get(a.label, bnd)
            known = a.label in lm_idx
            for hist in list(states_at.get(f, ())):
                src = (f, *hist)
                base = best.get(src)
                if base is None:
                    continue
                # First arcs (f == 0) carry no inter-word penalty — the
                # bigram contract (lattice_rescore charges pair[c, w] only
                # for c >= 0), so scores stay comparable across orders.
                edge = float(acoustic[i]) + (float(penalty) if f > 0 else 0.0)
                at_start = hist == start_hist and f == 0
                if known and (not at_start or boundaries):
                    edge += lm_weight * float(
                        trigram.log_p[hist[0], hist[1], w]
                    )
                new_hist = (hist[1], w)
                dst = (a.end, *new_hist)
                sc = base + edge
                if sc > best.get(dst, -np.inf):
                    best[dst] = sc
                    back[dst] = (src, i)
                    states_at.setdefault(a.end, set()).add(new_hist)

    finals = []
    for hist in states_at.get(lattice.num_frames, ()):
        node = (lattice.num_frames, *hist)
        sc = best.get(node)
        if sc is None:
            continue
        if boundaries:
            sc += lm_weight * float(
                trigram.log_p_final[hist[0], hist[1]]
            )
        finals.append((sc, node))
    if not finals:
        raise ValueError(
            "no arc chain spans the lattice (disconnected — widen the beam)"
        )
    score, node = max(finals, key=lambda sn: sn[0])
    path_arcs: List[LatticeArc] = []
    while node in back:
        node, i = back[node]
        path_arcs.append(arcs[i])
    path_arcs.reverse()
    text = "".join(
        a.label for a in path_arcs
        if not (skip_silence and a.label == lattice.silence_label)
    )
    return float(score), text, path_arcs


def exhaustive_lattice(composite, t_total: int) -> Lattice:
    """Every possible word arc: (start, end, w) for all spans long enough to
    traverse word w under the skip-2 band. Rescoring this lattice IS full
    search — the exactness oracle for lattice_rescore (test/debug utility;
    O(T^2 W) arcs, keep T small)."""
    arcs = []
    lowers = np.asarray(composite.lowers)
    uppers = np.asarray(composite.uppers)
    for w, label in enumerate(composite.labels):
        s_w = int(uppers[w] - lowers[w] + 1)
        min_len = 1 + -(-(s_w - 1) // 2)  # entry frame + ceil((s_w-1)/skip)
        for st in range(t_total):
            for en in range(st + min_len, t_total + 1):
                arcs.append(
                    LatticeArc(start=st, end=en, label=label, score=0.0)
                )
    sil = composite.labels[composite._silence_word] \
        if composite._silence_word is not None else None
    return Lattice(num_frames=t_total, arcs=arcs, silence_label=sil)


@dataclass
class ConfusionSlot:
    start: int   # frame span covered by the slot (anchor extent)
    end: int
    # word -> posterior mass; the epsilon (no word here) residual is
    # 1 - sum(values), floored at 0.
    hyps: Dict[str, float]
    pivot: Optional[str]  # 1-best word anchoring the slot; None = insertion

    def eps(self) -> float:
        return max(0.0, 1.0 - sum(self.hyps.values()))

    def best(self) -> Optional[str]:
        """argmax over words and epsilon; None when epsilon wins."""
        if not self.hyps:
            return None
        label, p = max(self.hyps.items(), key=lambda kv: kv[1])
        return None if self.eps() > p else label


def confusion_network(composite, features, beam: float = 50.0,
                      log_b=None, length: int | None = None,
                      skip_silence: bool = True, device=None) -> List[ConfusionSlot]:
    """Build the pivot confusion network (module docstring).

    Pivot slots are the 1-best word spans; every lattice arc joins the pivot
    it overlaps most (ties to the earlier pivot), arcs overlapping none form
    insertion slots clustered among themselves by overlap, ordered by start
    time. Slot masses are word-end posteriors P(w ends in this region | X)
    summed per label and clipped to 1."""
    from .lattice import _viterbi_no_quirk, forward_lattice

    feats = np.asarray(features)
    t_total = feats.shape[0] if length is None else int(length)
    log_b, _dev = emissions_of(composite, feats, log_b, device)
    lat = forward_lattice(
        composite, feats, beam=beam, log_b=log_b, posteriors=True,
        length=length,
    )
    path = _viterbi_no_quirk(composite, log_b[None], [t_total])[0]
    sil_w = composite._silence_word
    pivots = [
        (st, en, composite.labels[w])
        for st, en, w in path_word_spans(composite, path[:t_total])
        if not (skip_silence and sil_w is not None and w == sil_w)
    ]
    slots = [
        ConfusionSlot(start=st, end=en, hyps={}, pivot=lab)
        for st, en, lab in pivots
    ]

    def overlap(a_st, a_en, b_st, b_en):
        return max(0, min(a_en, b_en) - max(a_st, b_st))

    orphans: List[LatticeArc] = []
    for a in lat.arcs:
        if a.posterior is None:
            continue
        if skip_silence and a.label == lat.silence_label:
            continue
        ovs = [overlap(a.start, a.end, s.start, s.end) for s in slots]
        if slots and max(ovs) > 0:
            slot = slots[int(np.argmax(ovs))]
            slot.hyps[a.label] = min(
                1.0, slot.hyps.get(a.label, 0.0) + a.posterior
            )
        else:
            orphans.append(a)

    # Insertion slots: cluster orphan arcs among themselves by overlap,
    # highest-posterior arc anchors each cluster.
    extra: List[ConfusionSlot] = []
    for a in sorted(orphans, key=lambda x: -(x.posterior or 0.0)):
        for s in extra:
            if overlap(a.start, a.end, s.start, s.end) > 0:
                s.hyps[a.label] = min(
                    1.0, s.hyps.get(a.label, 0.0) + a.posterior
                )
                break
        else:
            extra.append(ConfusionSlot(
                start=a.start, end=a.end,
                hyps={a.label: min(1.0, a.posterior)}, pivot=None,
            ))
    return sorted(slots + extra, key=lambda s: (s.start, s.end))


def cn_decode(slots: Sequence[ConfusionSlot]) -> str:
    """Per-slot MBR: each slot's argmax word, epsilon slots emit nothing."""
    return "".join(w for w in (s.best() for s in slots) if w is not None)
