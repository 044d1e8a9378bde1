"""Word lattices and posterior confidences from the composite decoder.

The port of the JAX package's ops/lattice.py: time-aligned word arcs with
scores, deduped across hypotheses, and the sum-semiring posteriors behind
word confidences, keyword spotting and consensus decoding.

- ``nbest_lattice``: the k-best forward (ops/nbest.py) gives distinct state
  paths; each is segmented into word spans and identical (start, end, word)
  spans merge keeping the best full-path score.
- ``forward_lattice``: two whole-utterance max-plus passes over the dense
  (S, S) composite transition matrix, the forward carrying each cell's word
  entry time and the backward scoring the best continuation, give for every
  frame t and word w the best complete hypothesis in which w ends at t;
  every word end within ``beam`` of the best becomes an arc.
- ``word_confidences_batch`` / ``word_end_log_posteriors`` /
  ``word_occupancy_posteriors``: the sum-semiring forward and backward
  (logsumexp over the same matrix), batched over padded utterances with
  length masks. The 1-best path beside them is the dense max-plus decode
  without the backtrace quirk: K4 + K2-bt on the card
  (ops/cuda/trellis_dense.dense_decode_pallas), its plain version on the
  CPU, so the dense tie rules hold.

The passes run on the device the caller names (the card unless "cpu"), or
on log_b's device where log_b is a tensor: on the card one launch of the
LSUM kernel (sum passes), the LMAX kernel (max-plus passes) or the KBEST
kernel (the k-best forward), ops/cuda/trellis_lattice.py; on the CPU their
plain versions. Sums differ from the JAX package's only by their order
(stated in trellis_lattice.lattice_sum_passes_plain).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .cuda.trellis_lattice import lattice_max_passes, lattice_sum_passes, topology_of
from .nbest import emissions_of, kbest_composite_forward, nbest_paths
from .viterbi import NEG


@dataclass(frozen=True)
class LatticeArc:
    start: int   # first frame of the word instance (inclusive)
    end: int     # one past the last frame (exclusive)
    label: str
    score: float  # best full-path score among hypotheses using this arc
    # P(this word ends at end-1 | X) — attached by
    # forward_lattice(posteriors=True); None otherwise.
    posterior: float | None = None


@dataclass
class Lattice:
    num_frames: int
    arcs: List[LatticeArc] = field(default_factory=list)
    silence_label: str | None = "S"

    def sorted_arcs(self) -> List[LatticeArc]:
        return sorted(self.arcs, key=lambda a: (a.start, a.end, a.label))

    def contains(self, transcript: Sequence[str],
                 skip_silence: bool = True) -> bool:
        """Oracle check: is `transcript` spelled by some chain of abutting
        arcs from frame 0 to num_frames (silence arcs free when
        skip_silence)? DP over (frame, words matched)."""
        words = list(transcript)
        by_start: Dict[int, List[LatticeArc]] = {}
        for a in self.arcs:
            by_start.setdefault(a.start, []).append(a)
        reachable = {(0, 0)}
        frontier = [(0, 0)]
        while frontier:
            frame, k = frontier.pop()
            for a in by_start.get(frame, []):
                if skip_silence and a.label == self.silence_label:
                    nxt = (a.end, k)
                elif k < len(words) and a.label == words[k]:
                    nxt = (a.end, k + 1)
                else:
                    continue
                if nxt not in reachable:
                    reachable.add(nxt)
                    frontier.append(nxt)
        return (self.num_frames, len(words)) in reachable

    def oracle_edits(self, transcript: Sequence[str],
                     skip_silence: bool = True) -> int | None:
        """Minimum word edit distance between `transcript` and any chain of
        abutting arcs spanning frame 0 to num_frames (the lattice-oracle
        metric: 0 means the truth is in the lattice).

        DP over nodes (frame, ref words consumed): matching arcs cost 0,
        substitution arcs cost 1, any arc may be an insertion (cost 1), a
        ref word may be deleted at any node (cost 1), silence arcs are free
        when skip_silence. Returns None when no chain spans the utterance
        (disconnected lattice)."""
        words = list(transcript)
        n_ref = len(words)
        by_start: Dict[int, List[LatticeArc]] = {}
        for a in self.arcs:
            by_start.setdefault(a.start, []).append(a)
        frames = sorted({0, self.num_frames}
                        | {a.start for a in self.arcs}
                        | {a.end for a in self.arcs})
        inf = float("inf")
        cost = {(t, j): inf for t in frames for j in range(n_ref + 1)}
        cost[(0, 0)] = 0.0
        for t in frames:
            # Deletions advance j at the same frame; relax in j order.
            for j in range(n_ref):
                c = cost[(t, j)]
                if c + 1 < cost[(t, j + 1)]:
                    cost[(t, j + 1)] = c + 1
            for a in by_start.get(t, []):
                for j in range(n_ref + 1):
                    c = cost[(t, j)]
                    if c == inf:
                        continue
                    if skip_silence and a.label == self.silence_label:
                        steps = [(j, 0)]  # free pass-through
                    else:
                        steps = [(j, 1)]  # insertion
                        if j < n_ref:
                            steps.append(
                                (j + 1, 0 if a.label == words[j] else 1)
                            )
                    for nj, add in steps:
                        if c + add < cost[(a.end, nj)]:
                            cost[(a.end, nj)] = c + add
        best = cost[(self.num_frames, n_ref)]
        return None if best == inf else int(best)

    def to_dot(self) -> str:
        """Graphviz rendering: nodes are frame indices, arcs are words."""
        lines = ["digraph lattice {", "  rankdir=LR;"]
        nodes = sorted({a.start for a in self.arcs}
                       | {a.end for a in self.arcs})
        for t in nodes:
            lines.append(f'  n{t} [label="{t}"];')
        for a in self.sorted_arcs():
            lines.append(
                f'  n{a.start} -> n{a.end} '
                f'[label="{a.label}/{a.score:.1f}"];'
            )
        lines.append("}")
        return "\n".join(lines)


def path_word_spans(composite, path: np.ndarray) -> List[Tuple[int, int, int]]:
    """Segment a state path into word instances: [(start, end, word_idx)].

    Boundary rules mirror CompositeHMM.path_to_labels (a new instance begins
    when the word changes OR on an exit->entry re-entry of the same word —
    the repeated-word rule, reference model_boundary.py:131-135), but frame
    positions are kept instead of just the label sequence."""
    path = np.asarray(path, np.int64)
    return path_word_spans_batch(composite, path[None], [len(path)])[0]


def path_word_spans_batch(composite, paths, lengths) -> List[List[Tuple[int, int, int]]]:
    """path_word_spans of each row of paths (B, T) cut at its length, as one
    mask over the batch: a frame starts an instance where the state changes
    and the word changes or an exit re-enters its own word's entry."""
    paths = np.asarray(paths, np.int64)
    lengths = np.asarray(lengths, np.int64)
    b, t_total = paths.shape
    if t_total == 0:
        return [[] for _ in range(b)]
    live = np.arange(t_total) < lengths[:, None]
    paths = np.where(live, paths, 0)  # frames past a row's length hold any value
    word = np.asarray(composite.word_of_state)[paths]
    prev, cur, w = paths[:, :-1], paths[:, 1:], word[:, 1:]
    new = np.empty((b, t_total), bool)
    new[:, 0] = lengths > 0
    new[:, 1:] = (prev != cur) & ((w != word[:, :-1])
                                  | ((prev == np.asarray(composite.uppers)[w])
                                     & (cur == np.asarray(composite.lowers)[w])))
    new &= live
    rows, starts = np.nonzero(new)
    ends = np.append(starts[1:], 0)
    last = np.append(rows[1:] != rows[:-1], True)
    ends[last] = lengths[rows[last]]
    spans = list(zip(starts.tolist(), ends.tolist(), word[rows, starts].tolist()))
    bounds = np.concatenate(([0], np.cumsum(np.bincount(rows, minlength=b)))).tolist()
    return [spans[bounds[i]:bounds[i + 1]] for i in range(b)]


def nbest_lattice(composite, features, n: int = 8, beam_k: int | None = None,
                  log_b=None, quirk_backtrace: bool = True, device=None) -> Lattice:
    """Build a pruned word lattice from the n best distinct state paths.
    log_b overrides the emissions (e.g. GMM densities)."""
    if beam_k is None:
        beam_k = max(2 * n, 4)
    log_b, _dev = emissions_of(composite, features, log_b, device)
    alpha, backptrs = kbest_composite_forward(
        log_b, composite.log_a, composite.lower_of_state, composite.is_entry,
        composite.is_exit, composite.penalty, k=beam_k,
        topology=topology_of(composite, log_b.device),
    )
    t_total = int(np.asarray(features).shape[0])
    hyps = nbest_paths(alpha.cpu().numpy(), backptrs.cpu().numpy(), composite.is_exit,
                       t_total, n, quirk_backtrace=quirk_backtrace)
    best: Dict[Tuple[int, int, int], float] = {}
    for score, path in hyps:
        for span in path_word_spans(composite, path):
            prev = best.get(span)
            if prev is None or score > prev:
                best[span] = score
    sil = composite.labels[composite._silence_word] \
        if composite._silence_word is not None else None
    return Lattice(
        num_frames=t_total,
        arcs=[LatticeArc(start=st, end=en, label=composite.labels[w], score=float(sc))
              for (st, en, w), sc in best.items()],
        silence_label=sil,
    )


def _lattice_passes(composite, log_b, length: int):
    """The max-plus passes of one utterance (trellis_lattice
    lattice_max_passes: LMAX on the card): log_b (T, S) -> (alphas (T, S),
    entry_times (T, S) int32, beta_entry (T,): the best continuation from
    any word entry at each frame, emission included, and score: the Viterbi
    total). Rows at t >= length are garbage: read only frames < length."""
    return lattice_max_passes(log_b, topology_of(composite, log_b.device), composite.penalty,
                              length)


def _sum_passes(composite, log_b, lengths):
    """Length-masked sum-semiring passes over padded utterances (trellis_lattice
    lattice_sum_passes: LSUM on the card): log_b (B, T, S), lengths (B,)
    int32 on log_b's device -> (alphas (B, T, S), beta_em (B, T, S),
    beta_entry (B, T), log_z (B,)). Forward steps at t >= length freeze the
    carry; the backward re-seeds the exit terminal at t == length - 1, so
    padding never reaches live frames (rows at t >= length are garbage).
    Needs length >= 2 where T > length."""
    return lattice_sum_passes(log_b, topology_of(composite, log_b.device), composite.penalty,
                              lengths)


def _word_end_lambdas(composite, alphas, beta_entry, log_z, lengths):
    """(B, T, W) log P(word w ends at frame t | X) on the passes' device:
    alpha at w's exit + penalty + beta_entry[t + 1] - log Z for t <
    length - 1, alpha - log Z at t = length - 1, -inf past it."""
    dev = alphas.device
    b, t_total, _s = alphas.shape
    uppers = torch.as_tensor(np.asarray(composite.uppers), device=dev).to(torch.int64)
    a_exit = alphas[:, :, uppers]
    beta_next = torch.cat([beta_entry[:, 1:], beta_entry.new_full((b, 1), NEG)], dim=1)
    steps = torch.arange(t_total, device=dev)[None, :, None]
    last = lengths.to(torch.int64)[:, None, None] - 1
    cross = a_exit + composite.penalty + beta_next[:, :, None] - log_z[:, None, None]
    end = a_exit - log_z[:, None, None]
    return torch.where(steps < last, cross,
                       torch.where(steps == last, end, torch.full_like(end, NEG)))


def word_confidences_batch(composite, features, log_b=None,
                           skip_silence: bool = True, device=None):
    """Per-word posterior confidences for a ragged list of utterances:
    [[(label, start_frame, end_frame, confidence), ...] per utterance].
    The 128-padded batch is scored in one emission call, then one dense
    max-plus decode (no quirk) and one batch of sum-semiring passes; the
    word-end log posteriors are formed at the exits on the passes' device
    and only they, (B, T, W), come back. log_b optionally overrides the
    emissions as a ragged list (e.g. GMM densities); a list of tensors keeps
    their device."""
    from ..data.batching import pad_batch

    feats = [np.asarray(f) for f in features]
    lengths = np.asarray([f.shape[0] for f in feats], np.int32)
    if (lengths < 2).any():
        raise ValueError("word_confidences_batch needs utterances of >= 2 frames")
    if log_b is None:
        dev = resolve_device(device)
        padded = pad_batch(feats, 128)
        log_b_pad = composite.log_likelihoods(torch.as_tensor(padded.data, device=dev))
    else:
        log_b_list = [emissions_of(composite, f, lb, device)[0] for f, lb in zip(feats, log_b)]
        dev = log_b_list[0].device
        t_max = -(-int(lengths.max()) // 128) * 128
        log_b_pad = torch.zeros((len(feats), t_max, log_b_list[0].shape[1]), device=dev)
        for i, lb in enumerate(log_b_list):
            log_b_pad[i, : lb.shape[0]] = lb
    lengths_d = torch.as_tensor(lengths, device=dev)
    paths = _viterbi_no_quirk(composite, log_b_pad, lengths_d)
    alphas, _beta_em, beta_entry, log_z = _sum_passes(composite, log_b_pad, lengths_d)
    lam = _word_end_lambdas(composite, alphas, beta_entry, log_z, lengths_d).cpu().numpy()

    out = []
    for i, spans in enumerate(path_word_spans_batch(composite, paths, lengths)):
        words = []
        for st, en, w in spans:
            if skip_silence and composite._silence_word is not None \
                    and w == composite._silence_word:
                continue
            conf = float(np.exp(min(lam[i, en - 1, w], 0.0)))
            words.append((composite.labels[w], st, en, conf))
        out.append(words)
    return out


def _sum_quantities(composite, features, log_b=None, length=None, device=None):
    """The (length-masked) sum-semiring passes of one utterance as numpy:
    (log_b, alphas, beta_em, beta_entry, log_z). Rows at t >= length are
    garbage: read only frames < length."""
    feats = np.asarray(features)
    if length is None:
        length = feats.shape[0]
    if length < 2 and feats.shape[0] > length:
        # The backward re-seed lives at t == length - 1 >= 1.
        raise ValueError("padded posterior passes need length >= 2")
    log_b, dev = emissions_of(composite, feats, log_b, device)
    alphas, beta_em, beta_entry, log_z = _sum_passes(
        composite, log_b[None].contiguous(),
        torch.tensor([int(length)], dtype=torch.int32, device=dev))
    return (log_b.cpu().numpy(), alphas[0].cpu().numpy(), beta_em[0].cpu().numpy(),
            beta_entry[0].cpu().numpy(), float(log_z[0]))


def word_occupancy_posteriors(composite, features, log_b=None, length=None,
                              device=None) -> np.ndarray:
    """(T, W) frame-level word posteriors P(frame t lies in word w): state
    occupancies alpha + beta - log Z (the emission at t counted once),
    summed over each word's states; each row sums to 1."""
    feats = np.asarray(features)
    if length is None:
        length = feats.shape[0]
    log_b_np, alphas, beta_em, _beta_entry, log_z = _sum_quantities(
        composite, feats, log_b=log_b, length=length, device=device)
    log_gamma = (alphas + beta_em - log_b_np - log_z)[:length]
    gamma = np.exp(np.minimum(log_gamma, 0.0))
    word_of = np.asarray(composite.word_of_state)
    w = len(composite.labels)
    out = np.zeros((gamma.shape[0], w), gamma.dtype)
    for wi in range(w):
        out[:, wi] = gamma[:, word_of == wi].sum(axis=1)
    return out


def consensus_decode(composite, features, log_b=None, length=None,
                     min_frames: int = 3, skip_silence: bool = True, device=None) -> str:
    """Minimum-frame-error consensus decoding: per frame the word of highest
    occupancy posterior, run-length collapsed, runs shorter than min_frames
    dropped (adjacent repeats of one word merge)."""
    occ = word_occupancy_posteriors(composite, features, log_b=log_b, length=length,
                                    device=device)
    frame_words = occ.argmax(axis=1)
    out = []
    i = 0
    while i < len(frame_words):
        j = i
        while j < len(frame_words) and frame_words[j] == frame_words[i]:
            j += 1
        w = int(frame_words[i])
        if j - i >= min_frames and not (
            skip_silence and composite._silence_word is not None
            and w == composite._silence_word
        ):
            out.append(composite.labels[w])
        i = j
    return "".join(out)


def word_end_log_posteriors(composite, features, log_b=None, length=None,
                            device=None) -> np.ndarray:
    """(T, W) log P(word w ends at frame t | X): a cross-word hop at t + 1
    (exit mass + penalty + every entry continuation) or, at the last frame,
    the utterance ending at the exit."""
    feats = np.asarray(features)
    t_total = feats.shape[0] if length is None else int(length)
    _log_b, alphas, _beta_em, beta_entry, log_z = _sum_quantities(
        composite, feats, log_b=log_b, length=t_total, device=device)
    uppers = np.asarray(composite.uppers)
    lam = np.full((t_total, len(uppers)), -np.inf)
    a_exit = alphas[:t_total][:, uppers]
    lam[: t_total - 1] = (a_exit[: t_total - 1] + composite.penalty
                          + beta_entry[1:t_total, None] - log_z)
    lam[t_total - 1] = a_exit[t_total - 1] - log_z
    return lam


def _viterbi_no_quirk(composite, log_b, lengths):
    """Dense 1-best paths without the backtrace quirk (the JAX package's
    viterbi_composite_batch(quirk_backtrace=False)): log_b (B, T, S),
    lengths (B,) -> (B, T) numpy; K4 + K2-bt on the card."""
    from .cuda.trellis_dense import viterbi_composite_batch_pallas

    _scores, paths = viterbi_composite_batch_pallas(
        log_b, composite.log_a, composite.lower_of_state, composite.is_entry,
        composite.is_exit, composite.penalty, lengths, quirk_backtrace=False)
    return paths.cpu().numpy()


def word_confidences(composite, features, log_b=None, skip_silence: bool = True,
                     device=None):
    """The 1-best decode with a posterior confidence a word:
    [(label, start_frame, end_frame, confidence)], the confidence being
    P(this word ends at end - 1 | X)."""
    feats = np.asarray(features)
    log_b, dev = emissions_of(composite, feats, log_b, device)
    path = _viterbi_no_quirk(composite, log_b[None], [log_b.shape[0]])[0]
    lam = word_end_log_posteriors(composite, feats, log_b=log_b)
    out = []
    for st, en, w in path_word_spans(composite, path):
        if skip_silence and composite._silence_word is not None \
                and w == composite._silence_word:
            continue
        conf = float(np.exp(min(lam[en - 1, w], 0.0)))
        out.append((composite.labels[w], st, en, conf))
    return out


def _lattice_arcs(composite, a_exit, st_exit, beta_entry, best_total, beam, t_total):
    """The forward lattice's arcs {(start, end, word): score} from the exit
    columns: every (frame t, word w) whose best complete path ending w at t
    (alpha at w's exit + penalty + beta_entry[t + 1], or alpha alone at the
    last frame) is within beam of the best, keyed by its entry time."""
    arcs: Dict[Tuple[int, int, int], float] = {}
    for w in range(a_exit.shape[1]):
        a_e = a_exit[:, w]
        st_e = st_exit[:, w]
        sigma = np.full(t_total, -np.inf)
        sigma[: t_total - 1] = a_e[: t_total - 1] + composite.penalty + beta_entry[1:t_total]
        sigma[t_total - 1] = a_e[t_total - 1]
        for t in np.flatnonzero(sigma >= best_total - beam):
            key = (int(st_e[t]), int(t) + 1, w)
            sc = float(sigma[t])
            prev = arcs.get(key)
            if prev is None or sc > prev:
                arcs[key] = sc
    return arcs


def forward_lattice(composite, features, beam: float = 50.0, log_b=None,
                    posteriors: bool = False, length: int | None = None,
                    device=None) -> Lattice:
    """Forward lattice over word-end hypotheses: every (frame t, word w)
    whose best complete path ending w at t is within ``beam`` of the
    Viterbi best becomes an arc [entry_time, t + 1), entry_time carried by
    the forward's best token. posteriors=True attaches P(word ends at
    end - 1 | X). ``length`` marks the real frame count of padded
    features."""
    feats = np.asarray(features)
    t_total = feats.shape[0] if length is None else int(length)
    if t_total < 2 and feats.shape[0] > t_total:
        raise ValueError("padded forward_lattice needs length >= 2")
    log_b, _dev = emissions_of(composite, feats, log_b, device)
    alphas, ets, beta_entry, score = _lattice_passes(composite, log_b.contiguous(), t_total)
    uppers = np.asarray(composite.uppers)
    arcs = _lattice_arcs(composite, alphas.cpu().numpy()[:t_total, uppers],
                         ets.cpu().numpy()[:t_total, uppers], beta_entry.cpu().numpy(),
                         float(score), beam, t_total)
    lam = None
    if posteriors:
        lam = word_end_log_posteriors(composite, feats, log_b=log_b, length=t_total)
    sil = composite.labels[composite._silence_word] \
        if composite._silence_word is not None else None
    return Lattice(
        num_frames=t_total,
        arcs=[
            LatticeArc(
                start=st, end=en, label=composite.labels[w], score=sc,
                posterior=(float(np.exp(min(lam[en - 1, w], 0.0)))
                           if lam is not None else None),
            )
            for (st, en, w), sc in sorted(arcs.items())
        ],
        silence_label=sil,
    )


def spot_keyword(composite, features, keyword: str, threshold: float = 0.5,
                 beam: float = 50.0, log_b=None, length: int | None = None,
                 device=None) -> List[Tuple[int, int, float]]:
    """Posterior keyword spotting: [(start_frame, end_frame, posterior)] of
    forward_lattice(posteriors=True) arcs labelled ``keyword`` whose
    posterior clears ``threshold``, best first, overlaps suppressed."""
    if keyword not in composite.labels:
        raise ValueError(f"keyword {keyword!r} is not in the decoder vocabulary "
                         f"{composite.labels}")
    lat = forward_lattice(composite, features, beam=beam, log_b=log_b, posteriors=True,
                          length=length, device=device)
    hits = [(a.start, a.end, a.posterior) for a in lat.arcs
            if a.label == keyword and a.posterior is not None and a.posterior >= threshold]
    hits.sort(key=lambda h: -h[2])
    kept: List[Tuple[int, int, float]] = []
    for st, en, p in hits:
        if all(en <= k_st or st >= k_en for k_st, k_en, _p in kept):
            kept.append((st, en, p))
    return kept
