"""The fused embedded-training iteration: one Viterbi or Baum-Welch
re-estimation pass over the whole corpus on one device, with one small host
read per iteration.

A port of cs304_tpu/models/train_fused.py (Viterbi and Baum-Welch updates,
on one device or over a data-parallel mesh: the *_sharded entry points).
The reference semantics are unchanged (those of the JAX package's fused
program, itself parity-tested against its legacy per-transcript oracle and
reference hidden_markov_model.py:584-797):

  - topologies are runtime DATA: per-transcript sentence state tables
    (label, local state, word position) padded to the longest sentence, with
    per-utterance topology ids;
  - emissions are scored once against ALL (label, state) slots and gathered
    per sentence state;
  - the sentence trellis is purely banded (left-to-right skip-2; cross-word
    exit->entry edges are adjacent states, so they live inside the band) and
    runs over the WHOLE utterance batch at once: on a card one launch of the
    sentence decode mode of the scan-free team kernel (ops/cuda/
    trellis_banded.py, K3: forward, score and backtrace in one kernel);
  - the statistics use the hard Viterbi assignment: each frame belongs to
    exactly one (label, state) slot, so counts are integer histograms, sums
    one (slots, frames) x (frames, D) matmul, and the covariance pass centers
    each frame on its slot's NEW mean and takes one (slots, frames) x
    (frames, D^2) matmul per chunk of utterances;
  - the M-step (mean/cov/transition re-estimation with empty-slot keep,
    np.cov ddof=1 denominator, cov_reg*I) and the per-label allclose
    convergence test run on the device.

The Baum-Welch iteration (fused_bw_iteration) replaces the hard alignment by
the sentence forward-backward over the same band and the one-hots by the
posteriors gamma and, over the three band diagonals, within-word xi: on a
card one launch of the E-step mode of ops/cuda/trellis_fb.py, which hands
back gamma, the per-diagonal xi sums and ll, alpha and beta never written.

Every reduction is a matmul, a sum or an integer histogram, none a float
atomic, so two runs on one card give bitwise equal parameters. State and
transition ties pool in a fixed order too (_pool_slots over a TiePlan: each
group's members added in ascending row order by gathers, no scatter-add).
Everything is float32 with TF32 off (the JAX program's HIGHEST precision).

Over a mesh (parallel/data_parallel.py) every rank runs the same iteration on
its own block of chunks, and each sufficient statistic is summed over the
ranks (reduce_fn) exactly where the JAX program psums it: before the tie
pooling, in rank order, so every rank holds the same parameters bit for bit
and takes the same convergence decision.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import fp32_exact, resolve_device
from ..ops.cuda.emission import gaussian_log_pdf_quad_plain
from ..ops.cuda.trellis_banded import banded_decode, final_states
from ..ops.cuda.trellis_fb import (
    banded_fb_plain,
    banded_fb_posteriors,
    banded_fb_posteriors_plain,
    lse3,
    shift_states,
)
from ..ops.gaussian import (
    gaussian_log_pdf,
    make_gaussian_params,
    make_gaussian_quad_params,
)
from ..ops.viterbi import backtrace_batch, banded_sentence_forward

logger = logging.getLogger(__name__)

NEG = float("-inf")

# The training trellis: "scanfree" (default) runs the sentence decode kernel
# on a card (ops/cuda/trellis_banded.py; its plain version on the CPU), "scan"
# the plain PyTorch loop. The JAX package defaults to its XLA scan because
# compiling its Pallas kernel inside a while loop took many minutes through
# a remote TPU compiler and gained little over an already-fused scan.
# Neither holds here: nvcc builds the kernel in seconds, and the plain
# trellis is a Python loop of ~12 small launches per frame (at 896
# utterances x 160 frames x 59 states it takes tens of ms against a few
# hundredths of a ms for the kernel on an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md). Both give bitwise the same paths.
_TRELLIS_BACKEND = "scanfree"
# The Baum-Welch E-step: "kernel" (default) runs the E-step mode of the FB
# kernel on a card (ops/cuda/trellis_fb.banded_fb_posteriors; its plain
# version on the CPU), "plain" the plain PyTorch loop (about 25 small
# launches a step in each direction, then the posteriors).
_FB_BACKEND = "kernel"
# The soft-count floor of the Baum-Welch M-step (the JAX trainer's).
_BW_FLOOR = 1e-4


def _identity(x):
    return x


@dataclass
class FusedCorpus:
    """Device-resident corpus + topology tables for fused_viterbi_iteration."""

    batch: torch.Tensor      # (n_chunks, C, T, D) f32
    lengths: torch.Tensor    # (n_chunks, C) i32
    topo_id: torch.Tensor    # (n_chunks, C) i32
    lab_tab: torch.Tensor    # (n_topo, S_sent) i32
    loc_tab: torch.Tensor    # (n_topo, S_sent) i32
    pos_tab: torch.Tensor    # (n_topo, S_sent) i32 (pads hold distinct negatives)
    samew_tab: torch.Tensor  # (n_topo, S_sent, S_sent) bool
    cross_tab: torch.Tensor  # (n_topo, S_sent, S_sent) bool (exit -> next entry)
    n_states_t: torch.Tensor  # (n_topo,) i32
    num_utts: int            # real (non-padding) utterance count
    num_frames: int          # real frame count
    sentences: list          # topo index -> sentence string


def prepare_fused_corpus(
    labeled_features: Dict[str, Sequence[np.ndarray]],
    state_counts: Dict[str, int],
    label_index: Dict[str, int],
    insert_silence_fn,
    length_multiple: int = 128,
    chunk_utts: int = 64,
    device=None,
    num_shards: int = 1,
) -> FusedCorpus:
    """Pack every transcript's utterances into one padded corpus on
    ``device``.

    All utterances share one global T (padded to length_multiple) and one
    global sentence-state budget S_sent (the longest sentence); shorter
    sentences are padded with unreachable states. The utterance count is
    padded to a whole number of chunks with length-0 utterances, which
    contribute nothing to the statistics; num_shards > 1 pads the chunk
    count to a multiple of the mesh size, so the chunks divide over the
    ranks."""
    from .train_continuous import _entry_exit, _topology

    dev = resolve_device(device)
    sentences, topo_of_sentence = [], {}
    feats_all, lengths_all, topo_ids = [], [], []
    for transcript, feats in labeled_features.items():
        sentence = insert_silence_fn(transcript)
        if sentence not in topo_of_sentence:
            topo_of_sentence[sentence] = len(sentences)
            sentences.append(sentence)
        tid = topo_of_sentence[sentence]
        for x in feats:
            x = np.asarray(x, np.float32)
            feats_all.append(x)
            lengths_all.append(x.shape[0])
            topo_ids.append(tid)
    if not feats_all:
        raise ValueError("empty corpus")

    d = feats_all[0].shape[1]
    t_max = -(-max(lengths_all) // length_multiple) * length_multiple
    b = len(feats_all)
    c = min(chunk_utts, -(-b // 8) * 8)
    b_pad = -(-b // (c * num_shards)) * (c * num_shards)
    batch = np.zeros((b_pad, t_max, d), np.float32)
    for i, x in enumerate(feats_all):
        batch[i, : x.shape[0]] = x
    lengths = np.zeros(b_pad, np.int32)
    lengths[:b] = lengths_all
    topo_id = np.zeros(b_pad, np.int32)
    topo_id[:b] = topo_ids

    topos = [_topology(s, state_counts, label_index) for s in sentences]
    s_sent = max(len(t.lab_of_state) for t in topos)
    n_topo = len(topos)
    lab_tab = np.zeros((n_topo, s_sent), np.int32)
    loc_tab = np.zeros((n_topo, s_sent), np.int32)
    # Pad positions with distinct negatives so padded states never compare
    # equal to anything (not to real positions, not to each other).
    pos_tab = -1 - np.tile(np.arange(s_sent, dtype=np.int32), (n_topo, 1))
    n_states_t = np.zeros(n_topo, np.int32)
    samew_tab = np.zeros((n_topo, s_sent, s_sent), bool)
    cross_tab = np.zeros((n_topo, s_sent, s_sent), bool)
    for k, topo in enumerate(topos):
        n = len(topo.lab_of_state)
        n_states_t[k] = n
        lab_tab[k, :n] = topo.lab_of_state
        loc_tab[k, :n] = topo.loc_of_state
        pos_tab[k, :n] = topo.pos_of_state
        pos = topo.pos_of_state
        samew_tab[k, :n, :n] = pos[:, None] == pos[None, :]
        is_entry, is_exit = _entry_exit(pos)
        cross_tab[k, :n, :n] = (
            is_exit[:, None] & is_entry[None, :] & (pos[None, :] == pos[:, None] + 1)
        )

    n_chunks = b_pad // c

    def put(x):
        return torch.as_tensor(x, device=dev)

    return FusedCorpus(
        batch=put(batch.reshape(n_chunks, c, t_max, d)),
        lengths=put(lengths.reshape(n_chunks, c)),
        topo_id=put(topo_id.reshape(n_chunks, c)),
        lab_tab=put(lab_tab),
        loc_tab=put(loc_tab),
        pos_tab=put(pos_tab),
        samew_tab=put(samew_tab),
        cross_tab=put(cross_tab),
        n_states_t=put(n_states_t),
        num_utts=b,
        num_frames=int(sum(lengths_all)),
        sentences=sentences,
    )


def _sentence_trans_diagonals(log_a_g, lab_u, loc_u, samew_u, cross_u,
                              cross_word: str):
    """Per-utterance banded transition coefficients (c0=self, c1=prev, c2=skip).

    The full per-utterance sentence transition rule — word-internal entries
    gathered from the global (L, S, S) bank, cross-word entries free per the
    cross_word mode (train_continuous._sentence_log_a) — evaluated only on
    the 3 diagonals the skip-2 band can ever read: entry (j - k, j) of
    diagonal k, -inf where j < k."""
    if cross_word not in ("band", "exit_only"):
        raise ValueError(f"unknown cross_word {cross_word!r}")
    b, ss = lab_u.shape
    lab_u, loc_u = lab_u.to(torch.int64), loc_u.to(torch.int64)
    j = torch.arange(ss, device=lab_u.device)
    zero = torch.zeros((), dtype=log_a_g.dtype, device=log_a_g.device)
    neg = torch.full((), NEG, dtype=log_a_g.dtype, device=log_a_g.device)
    out = []
    for k in range(3):
        frm = torch.clamp(j - k, min=0)
        val = log_a_g[lab_u[:, frm], loc_u[:, frm], loc_u[:, j]]
        same = samew_u[:, frm, j]
        if cross_word == "band":
            la = torch.where(same, val, zero)
        else:
            la = torch.where(same, val, torch.where(cross_u[:, frm, j], zero, neg))
        out.append(la if k == 0 else torch.where(j >= k, la, neg))
    return tuple(out)


def _banded_trellis_batch(log_b, c0, c1, c2, lengths, n_states):
    """Whole-batch banded sentence Viterbi, plain PyTorch: the plain version
    of ops/cuda/trellis_banded.viterbi_banded_batch_scanfree.

    log_b (B, T, S_sent), coefficients (B, S_sent), lengths (B,),
    n_states (B,) -> (scores (B,), paths (B, T) i32). Tie-breaks match the
    dense scan's first-max argmax (smallest predecessor index wins), and the
    backtrace applies the reference's final-frame quirk."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=log_b.device)
    final = final_states(torch.as_tensor(n_states, device=log_b.device), log_b.shape[2])
    return _banded_trellis_final(log_b, c0, c1, c2, lengths, final)


def _banded_trellis_final(log_b, c0, c1, c2, lengths, final):
    """_banded_trellis_batch from int32 lengths and final states."""
    alpha, bps = banded_sentence_forward(log_b, c0, c1, c2, lengths)
    scores = alpha.gather(1, final[:, None].to(torch.int64))[:, 0]
    return scores, backtrace_batch(bps, final, lengths, quirk=True)


def _training_args(log_b, lengths, n_states):
    """int32 lengths and final states max(n - 1, 0) on log_b's device, with
    no check (final_states' would sync with the card between the emissions
    and the trellis): n_states <= S_sent holds by construction, S_sent being
    the longest sentence of prepare_fused_corpus."""
    dev = log_b.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    final = torch.clamp(torch.as_tensor(n_states, device=dev) - 1, min=0).to(torch.int32)
    return lengths, final


def _training_trellis(log_b, c0, c1, c2, lengths, n_states):
    """Dispatch the training trellis on _TRELLIS_BACKEND."""
    lengths, final = _training_args(log_b, lengths, n_states)
    if _TRELLIS_BACKEND == "scanfree":
        return banded_decode(log_b.contiguous(), c0.contiguous(), c1.contiguous(),
                             c2.contiguous(), lengths, final)
    if _TRELLIS_BACKEND == "scan":
        return _banded_trellis_final(log_b, c0, c1, c2, lengths, final)
    raise ValueError(f"unknown training trellis backend {_TRELLIS_BACKEND!r}")


_lse3 = lse3


def _banded_fb_batch(log_b, c0, c1, c2, lengths, n_states):
    """Whole-batch banded forward-backward over the sentence band, plain
    PyTorch: the plain version of ops/cuda/trellis_fb.banded_fb.

    log_b (B, T, S_sent), destination-indexed coefficients (B, S_sent)
    (c0 self, c1 from prev, c2 skip), lengths (B,), n_states (B,) ->
    (log_alpha (B, T, S), log_beta (B, T, S), ll (B,)), initial state pinned
    to 0 and termination to max(n_states - 1, 0)."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=log_b.device)
    final = final_states(torch.as_tensor(n_states, device=log_b.device), log_b.shape[2])
    return banded_fb_plain(log_b, c0, c1, c2, lengths, final)


def _training_fb(log_b, c0, c1, c2, lengths, n_states):
    """The Baum-Welch E-step, dispatched on _FB_BACKEND: -> (gamma
    (B, T, S), xi (B, 3, S), ll (B,)), see
    ops/cuda/trellis_fb.banded_fb_posteriors_plain."""
    lengths, final = _training_args(log_b, lengths, n_states)
    if _FB_BACKEND == "kernel":
        return banded_fb_posteriors(log_b.contiguous(), c0.contiguous(), c1.contiguous(),
                                    c2.contiguous(), lengths, final)
    if _FB_BACKEND == "plain":
        return banded_fb_posteriors_plain(log_b, c0, c1, c2, lengths, final)
    raise ValueError(f"unknown forward-backward backend {_FB_BACKEND!r}")


@dataclass(frozen=True)
class TiePlan:
    """A tie map's groups laid out once for a sum in a fixed order. Groups
    are ordered by size, largest first, so the groups with a k-th member
    are a prefix: ``members[k]`` holds the k-th smallest row of each of
    them. ``group_of`` maps each row to its group's position."""

    group_of: torch.Tensor                 # (N,) int64
    members: Tuple[torch.Tensor, ...]      # members[k]: (n_k,) int64, n_k falling


def tie_plan(tie, device=None):
    """tie (N,) group ids (an array or a tensor; untied rows carry unique
    ids) -> a TiePlan on ``device`` (the tensor's own by default). One host
    read of the map; None and a TiePlan pass through."""
    if tie is None or isinstance(tie, TiePlan):
        return tie
    if device is None:
        device = tie.device if isinstance(tie, torch.Tensor) else torch.device("cpu")
    ids = tie.cpu().numpy() if isinstance(tie, torch.Tensor) else np.asarray(tie)
    _keys, group = np.unique(ids.astype(np.int64), return_inverse=True)
    sizes = np.bincount(group)
    by_size = np.argsort(-sizes, kind="stable")  # groups, largest first
    position = np.empty_like(by_size)
    position[by_size] = np.arange(len(by_size))
    group_of = position[group.reshape(-1)]
    order = np.argsort(group_of, kind="stable")  # rows by group, ascending within
    starts = np.cumsum(sizes[by_size]) - sizes[by_size]
    rank = np.arange(len(order)) - starts[group_of[order]]
    members = tuple(order[rank == k] for k in range(int(sizes.max())))
    as_dev = lambda a: torch.as_tensor(a.astype(np.int64), device=device)  # noqa: E731
    return TiePlan(as_dev(group_of), tuple(as_dev(m) for m in members))


def _pool_slots(stat, tie):
    """Parameter tying: sum a statistic over the tie groups of its leading
    axis and broadcast each group total back to the members. tie: a TiePlan,
    or (N,) group ids for every row (a flat (label, state) slot, or a label
    for transition tying; untied rows carry unique ids, singleton groups,
    which pool to themselves).

    Each group's rows add in ascending order, ((0 + x0) + x1) + ..., one
    gather and add a member rank over the groups that have it: the order a
    sequential scatter-add takes, N rows read in all, and the same on a card
    in every run (no float atomics)."""
    plan = tie_plan(tie)
    acc = stat[plan.members[0]] + 0.0  # 0 + x0: a -0.0 start becomes +0.0
    for rows in plan.members[1:]:
        acc[: len(rows)] += stat[rows]
    return acc[plan.group_of]


def _couple_convergence(converged_l, conv_tie):
    """Freeze tie-connected labels together: a label counts as converged
    only when every label in its convergence group is."""
    conv_tie = conv_tie.to(torch.int64)
    bad = torch.zeros(converged_l.shape[0], dtype=torch.int32,
                      device=converged_l.device)
    bad.index_add_(0, conv_tie, (~converged_l).to(torch.int32))
    return bad[conv_tie] == 0


def _gather_sentence_emissions(means_g, covs_g, lab_tab, loc_tab,
                               batch, topo_id, s_max: int,
                               form: str = "whiten"):
    """All-slot Gaussian scoring, gathered per sentence state:
    (n_chunks, C, T, D) frames -> (n_chunks, C, T, S_sent).

    Chunked because the (frames, slots, D) whitened intermediate is the
    largest tensor of the iteration. form="whiten": float32 whitening
    matmul. form="quad": the quadratic-form layout's plain version (not the
    emission kernel), as the JAX trainer uses its plain quad form."""
    l, s, d = means_g.shape
    f = l * s
    n_chunks, c, t, _ = batch.shape
    if form == "quad":
        params = make_gaussian_quad_params(
            means_g.reshape(f, d), covs_g.reshape(f, d, d))
        emit = gaussian_log_pdf_quad_plain
    elif form == "whiten":
        params = make_gaussian_params(means_g.reshape(f, d), covs_g.reshape(f, d, d))
        emit = gaussian_log_pdf
    else:
        raise ValueError(f"unknown emissions form {form!r}")
    flat_slot = (lab_tab.to(torch.int64) * s_max + loc_tab.to(torch.int64))
    ss = flat_slot.shape[1]
    out = []
    for k in range(n_chunks):
        lb_all = emit(params, batch[k].reshape(c * t, d)).reshape(c, t, f)
        fs = flat_slot[topo_id[k].to(torch.int64)]  # (C, S_sent)
        out.append(lb_all.gather(2, fs[:, None, :].expand(c, t, ss)))
    return torch.stack(out)


def _histogram(idx, mask, n: int) -> torch.Tensor:
    """int64 counts of idx over [0, n) where mask holds: the sum of the
    masked one-hots, exact and order-free on any device (and summed over a
    mesh as integers)."""
    idx = torch.where(mask, idx, torch.full_like(idx, n))
    return torch.bincount(idx.reshape(-1), minlength=n + 1)[:n]


def _pass_a(paths_flat, lab_u, loc_u, pos_u, batch, lengths_flat, s_max: int,
            f: int):
    """Zeroth/first-order statistics and transition counts of the hard
    alignment: paths (B, T) over per-utterance tables (B, S_sent) ->
    (counts_f (F,) int64, sums (F, D), trans_f (F * s_max,) int64, one-hots
    (B, T, F) masked to real frames, slot of every frame (B, T))."""
    b, t = paths_flat.shape
    d = batch.shape[-1]
    dev = batch.device
    path_l = paths_flat.to(torch.int64)
    lab_p = lab_u.to(torch.int64).gather(1, path_l)
    loc_p = loc_u.to(torch.int64).gather(1, path_l)
    pos_p = pos_u.gather(1, path_l)
    flat = lab_p * s_max + loc_p
    mask = torch.arange(t, device=dev)[None, :] < lengths_flat[:, None]
    counts_f = _histogram(flat, mask, f)
    oh = torch.nn.functional.one_hot(flat, f).to(torch.float32) * mask[..., None]
    sums = oh.reshape(b * t, f).T @ batch.reshape(b * t, d)
    pair_live = (torch.arange(t - 1, device=dev)[None, :] < (lengths_flat[:, None] - 1)) & (
        pos_p[:, :-1] == pos_p[:, 1:]
    )
    from_flat = (
        lab_p[:, :-1] * (s_max * s_max) + loc_p[:, :-1] * s_max + loc_p[:, 1:]
    )
    trans_f = _histogram(from_flat, pair_live, f * s_max)
    return counts_f, sums, trans_f, oh, flat


def _pass_b(batch, flat, oh, new_means_flat):
    """Covariance pass centered on the NEW means (np.cov parity), one chunk
    of utterances at a time so x2 stays (C*T, D^2) floats: batch
    (n_chunks, C, T, D), flat (B, T) slots, oh (B, T, F) -> m2 (F, D*D)."""
    n_chunks, c, t, d = batch.shape
    f = oh.shape[-1]
    flat_c = flat.reshape(n_chunks, c * t)
    oh_c = oh.reshape(n_chunks, c * t, f)
    m2_flat = torch.zeros((f, d * d), dtype=torch.float32, device=batch.device)
    for k in range(n_chunks):
        # Hard assignment: each frame has exactly one slot, so centering is a
        # single per-frame gather of that slot's new mean.
        xc = batch[k].reshape(c * t, d) - new_means_flat[flat_c[k]]
        x2 = (xc[:, :, None] * xc[:, None, :]).reshape(c * t, d * d)
        m2_flat = m2_flat + oh_c[k].T @ x2
    return m2_flat


def _iteration_body(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    *, cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str,
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
    reduce_fn=_identity,
):
    """One fused Viterbi iteration (see fused_viterbi_iteration).

    reduce_fn sums each sufficient statistic over the mesh (identity on one
    device): the counts and transition counts as integers, the frame sums and
    second moments as float32, each before the tie pooling.

    tie_flat (F,) / trans_tie (L,) int or their TiePlans, optional:
    state-level emission tying and label-level transition tying — statistics
    pool over tie groups before the M-step (see _pool_slots), so tied slots
    train as ONE shared distribution. conv_tie (L,) int, optional: convergence-coupling groups —
    labels sharing a tie group freeze TOGETHER; untied labels keep the
    reference's per-label freeze semantics."""
    fp32_exact()
    l, s, d = means_g.shape
    f = num_labels * s_max
    n_chunks, c, t, _ = batch.shape
    b = n_chunks * c
    dev = batch.device
    tie_flat, trans_tie = tie_plan(tie_flat), tie_plan(trans_tie)

    lb_sent = _gather_sentence_emissions(
        means_g, covs_g, lab_tab, loc_tab, batch, topo_id, s_max,
        form=emissions,
    )
    s_sent = lb_sent.shape[-1]

    # ---- trellis: ONE whole-batch alignment.
    topo_flat = topo_id.reshape(b).to(torch.int64)
    c0, c1, c2 = _sentence_trans_diagonals(
        log_a_g, lab_tab[topo_flat], loc_tab[topo_flat],
        samew_tab[topo_flat], cross_tab[topo_flat], cross_word,
    )
    lengths_flat = lengths.reshape(b)
    _scores, paths_flat = _training_trellis(
        lb_sent.reshape(b, t, s_sent), c0, c1, c2,
        lengths_flat, n_states_t[topo_flat],
    )

    # ---- pass A
    counts_f, sums, trans_f, oh, flat = _pass_a(
        paths_flat, lab_tab[topo_flat], loc_tab[topo_flat], pos_tab[topo_flat],
        batch, lengths_flat, s_max, f,
    )
    counts_f = reduce_fn(counts_f).to(torch.float32)
    sums = reduce_fn(sums)
    trans_f = reduce_fn(trans_f).to(torch.float32)
    if tie_flat is not None:
        counts_f = _pool_slots(counts_f, tie_flat)
        sums = _pool_slots(sums, tie_flat)
    counts = counts_f.reshape(l, s)
    trans = trans_f.reshape(l, s, s)
    if trans_tie is not None:
        trans = _pool_slots(trans, trans_tie)

    # ---- M-step: means + convergence ----
    empty = slot_used & (counts < 1.0)
    new_means = (sums / torch.clamp(counts_f, min=1.0)[:, None]).reshape(l, s, d)
    new_means = torch.where(empty[..., None], means_g, new_means)
    # np.allclose(new, old): |new - old| <= atol + rtol * |old|.
    close = torch.abs(new_means - means_g) <= atol + rtol * torch.abs(means_g)
    converged_l = torch.all(close.all(-1) | ~slot_used, dim=-1)  # (L,)
    if conv_tie is not None:
        converged_l = _couple_convergence(converged_l, conv_tie)

    # ---- pass B
    m2_flat = reduce_fn(_pass_b(batch, flat, oh, new_means.reshape(f, d)))
    if tie_flat is not None:
        # Tied slots share new_means, so each pooled m2 is centered at its
        # group mean — the group covariance with np.cov ddof=1 on the GROUP
        # count follows exactly.
        m2_flat = _pool_slots(m2_flat, tie_flat)
    m2 = m2_flat.reshape(l, s, d, d)
    denom = torch.clamp(counts - 1.0, min=1.0)[..., None, None]  # np.cov ddof=1
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    new_covs = m2 / denom + cov_reg * eye
    new_covs = torch.where(empty[..., None, None], covs_g, new_covs)
    # Padded slots keep identity covariance so the next Cholesky stays valid.
    new_covs = torch.where(slot_used[..., None, None], new_covs, eye)

    # ---- transitions ----
    row_sums = trans.sum(dim=2, keepdim=True)
    probs = trans / torch.clamp(row_sums, min=1.0)
    new_log_a = torch.where(probs > 0, torch.log(probs),
                            torch.full_like(probs, NEG))
    no_out = (row_sums[..., 0] < 1.0) & slot_used
    new_log_a = torch.where(no_out[..., None], log_a_g, new_log_a)

    # Converged labels keep their parameters this iteration (reference raises
    # HMMTrainConverge before assignment, hidden_markov_model.py:333-335).
    keep = converged_l[:, None, None]
    new_means = torch.where(keep, means_g, new_means)
    new_covs = torch.where(keep[..., None], covs_g, new_covs)
    new_log_a = torch.where(keep, log_a_g, new_log_a)

    return (new_means, new_covs, new_log_a, counts, converged_l,
            paths_flat.reshape(n_chunks, c, t))


def fused_viterbi_iteration(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str = "exit_only",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """One embedded-training iteration on the tensors' device.

    Returns (new_means, new_covs, new_log_a, counts, converged_l, paths):
    the COMMITTED M-step result — empty-slot/no-outgoing keep-old applied AND
    the per-label converged mask applied (converged models keep their
    parameters, reference hidden_markov_model.py:333-335) — per-slot frame
    counts, per-label convergence flags (reference allclose on means), and
    the Viterbi paths (n_chunks, C, T). The returned parameters can be fed
    straight back in as the next iteration's state; the host only reads
    counts (empty-slot policy) and converged_l (stop).
    """
    return _iteration_body(
        means_g, covs_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
        cov_reg=cov_reg, rtol=rtol, atol=atol,
        num_labels=num_labels, s_max=s_max, cross_word=cross_word,
        emissions=emissions, tie_flat=tie_flat, trans_tie=trans_tie,
        conv_tie=conv_tie,
    )


def _bw_pass_a(gam, xi, lab_u, loc_u, samew_u, batch, s_max: int, f: int):
    """Soft zeroth/first-order statistics and within-word transition mass
    over the whole batch, from the E-step's gamma (B, T, S_sent) and xi
    sums (B, 3, S_sent) -> (counts_f (F,), sums (F, D), trans_f
    (F * s_max,), gam_f (B, T, F)). xi's diagonal k is destination-indexed
    (the value at state v comes from v - k), and only pairs inside one word
    count: the same-word mask does not depend on t, so masking the sums
    over t equals masking every term."""
    b, t, ss = gam.shape
    d = batch.shape[-1]
    dev = gam.device
    lab_u, loc_u = lab_u.to(torch.int64), loc_u.to(torch.int64)
    flat_slot = lab_u * s_max + loc_u  # (B, S_sent)
    oh = torch.nn.functional.one_hot(flat_slot, f).to(torch.float32)  # (B, S, F)
    gam_f = torch.bmm(gam, oh)  # (B, T, F)
    counts_f = gam_f.sum(dim=(0, 1))
    sums = gam_f.reshape(b * t, f).T @ batch.reshape(b * t, d)

    ar = torch.arange(ss, device=dev)
    trans_f = torch.zeros((f * s_max,), dtype=torch.float32, device=dev)
    for k in range(3):
        if k == 0:
            xi_sum = xi[:, 0]
            loc_from = loc_u
        else:
            frm = torch.clamp(ar - k, min=0)
            samew_k = samew_u[:, frm, ar] & (ar >= k)
            xi_sum = torch.where(samew_k, xi[:, k], torch.zeros_like(xi[:, k]))
            loc_from = shift_states(loc_u, k, 0)
        from_flat = lab_u * (s_max * s_max) + loc_from * s_max + loc_u
        ohp = torch.nn.functional.one_hot(from_flat, f * s_max).to(torch.float32)
        trans_f = trans_f + xi_sum.reshape(1, b * ss) @ ohp.reshape(b * ss, f * s_max)
    return counts_f, sums, trans_f.reshape(-1), gam_f


def _bw_pass_b(batch, gam_f, c_glob):
    """Second moments around the fixed point c_glob, one chunk of utterances
    at a time so x2 stays (C*T, D^2) floats -> sxx (F, D*D)."""
    n_chunks, c, t, d = batch.shape
    f = gam_f.shape[-1]
    gam_c = gam_f.reshape(n_chunks, c * t, f)
    sxx = torch.zeros((f, d * d), dtype=torch.float32, device=batch.device)
    for k in range(n_chunks):
        xc = batch[k].reshape(c * t, d) - c_glob
        x2 = (xc[:, :, None] * xc[:, None, :]).reshape(c * t, d * d)
        sxx = sxx + gam_c[k].T @ x2
    return sxx


def _bw_body(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    *, cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str,
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
    reduce_fn=_identity,
):
    """One fused Baum-Welch iteration (see fused_bw_iteration); reduce_fn
    as in _iteration_body (ll_sum, soft counts, sums, transition mass, sxx).

    Soft forward-backward posteriors over the banded sentence topology
    replace the hard Viterbi one-hots. Cross-word xi mass is excluded from
    the transition counts (within-word pairs only) and termination is pinned
    to the sentence's last state, as in the JAX package.

    The covariance uses the Koenig decomposition around the global weighted
    mean c: sum_t w_tf (x - mu_f)(x - mu_f)^T = sum_t w_tf (x - c)(x - c)^T
    - counts_f d_f d_f^T with d_f = mu_f - c; both accumulated terms are
    centred (residuals of the corpus spread, not raw magnitudes), so one
    float32 matmul a chunk suffices.

    Returns (new_means, new_covs, new_log_a, counts, converged_l, ll_sum)."""
    fp32_exact()
    l, s, d = means_g.shape
    f = num_labels * s_max
    n_chunks, c, t, _ = batch.shape
    b = n_chunks * c
    dev = batch.device
    tie_flat, trans_tie = tie_plan(tie_flat), tie_plan(trans_tie)

    lb_sent = _gather_sentence_emissions(
        means_g, covs_g, lab_tab, loc_tab, batch, topo_id, s_max, form=emissions,
    ).reshape(b, t, -1)
    topo_flat = topo_id.reshape(b).to(torch.int64)
    lab_u, loc_u, samew_u = lab_tab[topo_flat], loc_tab[topo_flat], samew_tab[topo_flat]
    diags = _sentence_trans_diagonals(log_a_g, lab_u, loc_u, samew_u,
                                      cross_tab[topo_flat], cross_word)
    lengths_flat = lengths.reshape(b)
    # ---- E-step: gamma and the per-diagonal xi sums; padding utterances
    # (ll = -inf) count nothing and add 0 to the summed log-likelihood.
    gam, xi, ll = _training_fb(lb_sent, *diags, lengths_flat, n_states_t[topo_flat])
    ll_sum = reduce_fn(torch.where(torch.isfinite(ll), ll, torch.zeros_like(ll)).sum())

    # ---- pass A: soft counts / frame sums / within-word transition mass
    counts_f, sums, trans_f, gam_f = _bw_pass_a(
        gam, xi, lab_u, loc_u, samew_u, batch, s_max, f)
    counts_f = reduce_fn(counts_f)
    sums = reduce_fn(sums)
    trans_f = reduce_fn(trans_f)
    if tie_flat is not None:
        counts_f = _pool_slots(counts_f, tie_flat)
        sums = _pool_slots(sums, tie_flat)
    counts = counts_f.reshape(l, s)
    trans = trans_f.reshape(l, s, s)
    if trans_tie is not None:
        trans = _pool_slots(trans, trans_tie)

    # ---- M-step: means + convergence (soft-count floors) ----
    empty = slot_used & (counts < _BW_FLOOR)
    new_means = (sums / torch.clamp(counts_f, min=_BW_FLOOR)[:, None]).reshape(l, s, d)
    new_means = torch.where(empty[..., None], means_g, new_means)
    close = torch.abs(new_means - means_g) <= atol + rtol * torch.abs(means_g)
    converged_l = torch.all(close.all(-1) | ~slot_used, dim=-1)
    if conv_tie is not None:
        converged_l = _couple_convergence(converged_l, conv_tie)

    # ---- pass B: covariance (Koenig around the global weighted mean) ----
    new_means_flat = new_means.reshape(f, d)
    total = torch.clamp(counts_f.sum(), min=_BW_FLOOR)
    c_glob = sums.sum(dim=0) / total
    d_f = new_means_flat - c_glob
    sxx_flat = reduce_fn(_bw_pass_b(batch, gam_f, c_glob))
    if tie_flat is not None:
        # Koenig holds for any fixed centring point: pooled sxx with the
        # pooled counts and the shared group mean is the group covariance.
        sxx_flat = _pool_slots(sxx_flat, tie_flat)
    m2 = (sxx_flat.reshape(f, d, d)
          - counts_f[:, None, None] * (d_f[:, :, None] * d_f[:, None, :])).reshape(l, s, d, d)
    denom = torch.clamp(counts, min=_BW_FLOOR)[..., None, None]
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    new_covs = m2 / denom + cov_reg * eye
    new_covs = torch.where(empty[..., None, None], covs_g, new_covs)
    new_covs = torch.where(slot_used[..., None, None], new_covs, eye)

    # ---- transitions ----
    row_sums = trans.sum(dim=2, keepdim=True)
    probs = trans / torch.clamp(row_sums, min=_BW_FLOOR)
    new_log_a = torch.where(probs > 0, torch.log(probs), torch.full_like(probs, NEG))
    no_out = (row_sums[..., 0] < _BW_FLOOR) & slot_used
    new_log_a = torch.where(no_out[..., None], log_a_g, new_log_a)

    keep = converged_l[:, None, None]
    new_means = torch.where(keep, means_g, new_means)
    new_covs = torch.where(keep[..., None], covs_g, new_covs)
    new_log_a = torch.where(keep, log_a_g, new_log_a)
    return new_means, new_covs, new_log_a, counts, converged_l, ll_sum


def fused_bw_iteration(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str = "exit_only",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """One embedded Baum-Welch iteration on the tensors' device (_bw_body).
    Returns (new_means, new_covs, new_log_a, counts, converged_l, ll_sum)."""
    return _bw_body(
        means_g, covs_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
        cov_reg=cov_reg, rtol=rtol, atol=atol,
        num_labels=num_labels, s_max=s_max, cross_word=cross_word,
        emissions=emissions, tie_flat=tie_flat, trans_tie=trans_tie,
        conv_tie=conv_tie,
    )


def fused_train_run(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str,
    max_iterations: int, update: str = "viterbi",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """The remaining embedded training run: fused iterations until every
    label converges or max_iterations, reading one flag back per iteration.
    The iteration that detects convergence counts (its parameter updates are
    already suppressed by the converged-label keep mask), as in the JAX
    package's while loop.

    update: "viterbi" (_iteration_body) or "baum_welch" (_bw_body).

    Returns (means, covs, log_a, counts, iterations, converged); the last two
    are a Python int and bool."""
    return _train_run(
        means_g, covs_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
        cov_reg=cov_reg, rtol=rtol, atol=atol, num_labels=num_labels, s_max=s_max,
        cross_word=cross_word, max_iterations=max_iterations, update=update,
        emissions=emissions, tie_flat=tie_flat, trans_tie=trans_tie, conv_tie=conv_tie,
    )


def _train_run(means_g, covs_g, log_a_g, *tables, max_iterations: int, update: str,
               num_labels: int, s_max: int, reduce_fn=_identity, **kw):
    """fused_train_run's loop, with reduce_fn for the sharded run."""
    bodies = {"viterbi": _iteration_body, "baum_welch": _bw_body}
    if update not in bodies:
        raise ValueError(f"update={update!r} is not one of {sorted(bodies)}")
    body_fn = bodies[update]
    means, covs, log_a = means_g, covs_g, log_a_g
    counts = torch.zeros((num_labels, s_max), dtype=torch.float32,
                         device=means_g.device)
    it, converged = 0, False
    while it < max_iterations and not converged:
        means, covs, log_a, counts, converged_l, _ = body_fn(
            means, covs, log_a, *tables, num_labels=num_labels, s_max=s_max,
            reduce_fn=reduce_fn, **kw)
        it += 1
        converged = bool(converged_l.all())
    return means, covs, log_a, counts, it, converged


# -- over a data-parallel mesh (parallel/data_parallel.py) ---------------------
#
# SPMD: every rank calls these with the same full corpus and the same
# replicated parameters and tables; each rank takes its contiguous block of
# the chunk axis (shard_rows: batch.shape[0] must divide over the ranks, as
# prepare_fused_corpus(num_shards=mesh size) pads it), and reduce_fn sums the
# statistics over the ranks in rank order. Returned parameters, counts and
# flags are bitwise the same on every rank, so every rank runs the same
# number of iterations and joins every collective; a rank whose block is
# all padding (length-0 utterances) computes zero statistics and still
# joins them.

def _sharded(args, mesh):
    """The iteration's positional arguments with the corpus (the last three)
    cut to this rank's block of chunks."""
    from ..parallel.data_parallel import shard_rows

    *replicated, batch, lengths, topo_id = args
    return (*replicated, *(shard_rows(x, mesh) for x in (batch, lengths, topo_id)))


def fused_viterbi_iteration_sharded(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str = "exit_only",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """fused_viterbi_iteration over a data-parallel mesh: each rank aligns
    its block of chunks, the sufficient statistics are summed over the
    ranks, and the M-step runs replicated. Returns what
    fused_viterbi_iteration returns, the paths gathered to the full
    (n_chunks, C, T) on every rank."""
    from ..parallel.data_parallel import gather_rows, reducer

    args = (means_g, covs_g, log_a_g, slot_used,
            lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
            batch, lengths, topo_id)
    *out, paths = _iteration_body(
        *_sharded(args, mesh),
        cov_reg=cov_reg, rtol=rtol, atol=atol,
        num_labels=num_labels, s_max=s_max, cross_word=cross_word,
        emissions=emissions, tie_flat=tie_flat, trans_tie=trans_tie,
        conv_tie=conv_tie, reduce_fn=reducer(mesh),
    )
    return (*out, gather_rows(paths, mesh))


def fused_bw_iteration_sharded(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str = "exit_only",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """fused_bw_iteration over a data-parallel mesh (soft statistics and the
    log-likelihood summed over the ranks); every output replicated."""
    from ..parallel.data_parallel import reducer

    args = (means_g, covs_g, log_a_g, slot_used,
            lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
            batch, lengths, topo_id)
    return _bw_body(
        *_sharded(args, mesh),
        cov_reg=cov_reg, rtol=rtol, atol=atol,
        num_labels=num_labels, s_max=s_max, cross_word=cross_word,
        emissions=emissions, tie_flat=tie_flat, trans_tie=trans_tie,
        conv_tie=conv_tie, reduce_fn=reducer(mesh),
    )


def fused_train_run_sharded(
    means_g, covs_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, cross_word: str,
    max_iterations: int, update: str = "viterbi",
    emissions: str = "whiten",
    tie_flat=None, trans_tie=None, conv_tie=None,
):
    """fused_train_run over a data-parallel mesh: every rank loops over the
    same iterations (the replicated convergence flags decide), summing the
    statistics over the ranks in each. Returns what fused_train_run
    returns."""
    from ..parallel.data_parallel import reducer

    args = (means_g, covs_g, log_a_g, slot_used,
            lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
            batch, lengths, topo_id)
    return _train_run(
        *_sharded(args, mesh),
        cov_reg=cov_reg, rtol=rtol, atol=atol, num_labels=num_labels, s_max=s_max,
        cross_word=cross_word, max_iterations=max_iterations, update=update,
        emissions=emissions, tie_flat=tie_flat, trans_tie=trans_tie, conv_tie=conv_tie,
        reduce_fn=reducer(mesh),
    )
