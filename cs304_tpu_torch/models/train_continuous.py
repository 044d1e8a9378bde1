"""Embedded continuous training over digit-string transcripts (project6).

Reference algorithm (hidden_markov_model.py:667-797):
  - every transcript "4Z2Z1" becomes the silence-interleaved sentence
    "S4SZS2SZS1S" (insert_silence, :794-797)
  - a sentence HMM is concatenated from the current word models (:638-664)
  - every utterance of that transcript is Viterbi-aligned against it, the path
    is cut at word boundaries, and the per-word frame segments are pooled
    ("remuxed", :602-636)
  - each word model is re-estimated from its pooled segments with the same
    segmental k-means M-step as isolated training (:754-770)
  - training stops when every model's means are converged (allclose)

This is the PyTorch port of cs304_tpu/models/train_continuous.py. By default
every iteration is models/train_fused.py's fused Viterbi iteration
(alignment of every utterance, sufficient statistics, M-step, convergence
test) on the trainer's device, whose sentence trellis is the banded CUDA
kernel on a card, or with update="baum_welch" its fused Baum-Welch
iteration, whose sentence forward-backward is the FB kernel on a card.
fused=False runs the legacy per-transcript oracle (_iteration): one
alignment and statistics pass per transcript (_stats_pass: the banded word
trellis of ops/viterbi.viterbi_banded_batch over the transcript's gathered
sentence, one launch of the sentence kernel on a card; _stats_pass_bw: the
dense forward-backward of ops/forward_backward.py), the statistics summed
in float64 on the host, then a centered covariance pass around the new
means. GMM models train with models/train_continuous_gmm.py's
GMMContinuousTrainer: given one, train() raises a ValueError that says so
(the JAX trainer fails there too, with a ValueError of its own). With
mesh= (parallel/data_parallel.make_mesh) the fused iterations run over a
data-parallel mesh: each rank aligns its block of the corpus, the
statistics are summed over the ranks, and every rank holds the same
parameters (models/train_fused.py's *_sharded entry points).

Convergence semantics divergence (documented): the reference counts
convergence events CUMULATIVELY across iterations and stops when the running
total equals the number of models (hidden_markov_model.py:760-765) — so one
model re-converging every iteration can end training alone. We implement the
evident intent: stop when all models converge in the same iteration.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..data.batching import pad_batch
from ..device import fp32_exact, resolve_device
from ..ops.forward_backward import forward_backward
from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import banded_transition_matrix, viterbi_banded_batch
from .hmm import WordHMM
from .train_kmeans import HMMTrainMeanFail, SegmentalKMeansConfig, train_word_hmm

logger = logging.getLogger(__name__)

SILENCE_LABEL = "S"
NEG = float("-inf")


def insert_silence(labels):
    """'4Z2' -> 'S4SZS2S' (reference hidden_markov_model.py:794-797).

    Transcripts are either strings of single-char labels (the reference's
    digit strings) or sequences of multi-char word labels; the interleaved
    sentence keeps the input's type so topology caches key consistently.
    """
    if isinstance(labels, str):
        return "S" + "S".join(labels) + "S" if labels else "S"
    out = ["S"]
    for label in labels:
        out.append(label)
        out.append("S")
    return tuple(out)


@dataclass(frozen=True)
class ContinuousTrainConfig:
    max_iterations: int = 100
    # The reference regularizes covariances with 0.001*I
    # (hidden_markov_model.py:341-345) and that is the default here. NOTE:
    # the in-repo synthetic benchmarks/tests pass cov_reg=0.1 instead — the
    # synthetic corpus has far fewer takes per transcript than real TI-Digits,
    # so per-state covariances need heavier regularization to stay
    # well-conditioned. This is a deliberate, surfaced divergence; keep 0.001
    # for real-sized corpora.
    cov_reg: float = 0.001
    length_multiple: int = 128
    rtol: float = 1e-5
    atol: float = 1e-8
    insert_silence: bool = True
    # What to do when a (label, state) slot receives zero aligned frames.
    # "fail" replicates the reference's abort (HMMTrainMeanFail,
    # hidden_markov_model.py:214-217); "keep" freezes that slot's previous
    # parameters for the iteration — free cross-word transitions let paths
    # skip word-entry states, so sparse corpora hit this routinely.
    on_empty_state: str = "keep"
    # Re-train the silence model on long in-context silence runs before joint
    # re-estimation. The boot silence model comes from standalone noise clips
    # whose power_to_db ref=max is the NOISE's own peak, so it is
    # systematically mismatched against in-utterance silence (~-40 dB below the
    # speech peak); aligning with it poisons the first joint iteration. The
    # bootstrap pools only S-aligned runs of >= silence_bootstrap_min_run
    # frames (long runs are true silence; 1-2 frame runs are attack/decay
    # contamination) and re-estimates S alone with digits frozen.
    silence_bootstrap: bool = True
    silence_bootstrap_min_run: int = 9
    silence_label: str = SILENCE_LABEL
    # Statistics used for re-estimation. "viterbi" (default) replicates the
    # reference's segmental update: hard path counts from the banded sentence
    # Viterbi (hidden_markov_model.py:588-600). "baum_welch" replaces them by
    # forward-backward posteriors over the same banded sentence topology
    # (soft counts, floor 1e-4; cross-word xi excluded).
    update: str = "viterbi"
    # Run each iteration as models/train_fused.py's fused iteration (every
    # transcript aligned in one batch, statistics on the device). fused=False
    # runs the legacy per-transcript oracle: an independent implementation
    # (its own one-hot statistics, JAX's legacy formulas) kept for parity
    # tests, MAP adaptation's statistics and benchmarks; single-host only.
    fused: bool = True
    # Emission layout inside the fused iteration. "whiten" (default):
    # float32 whitening matmul. "quad": the quadratic-form layout (plain
    # PyTorch, ops/cuda/emission.gaussian_log_pdf_quad_plain), one
    # (frames, D^2) x (D^2, slots) matmul; ~1e-3 absolute emission error that
    # only perturbs exact near-ties in the alignment argmax.
    emissions: str = "whiten"
    # Cross-word transition topology of the training sentence HMM.
    # "exit_only" (default): words connect ONLY exit -> next entry, matching
    # the decoder's composite topology, so every word instance traverses its
    # entry and exit states and every state receives frames.
    # "band": the reference's accidental free skip-2 band across word
    # boundaries (its sparse matrix returns 0.0 for unstored cross-word keys,
    # transition_probability.py:17-23) — under it, entry/exit states can be
    # skipped during alignment and keep stale parameters that the decoder
    # then has to pay for (observed as word deletions).
    cross_word: str = "exit_only"


@dataclass
class _SentenceTopology:
    """Static per-transcript-shape arrays mapping sentence states to
    (global label index, local state)."""

    lab_of_state: np.ndarray  # (S_sent,) int32 into the global label list
    loc_of_state: np.ndarray  # (S_sent,) int32 local state within the word
    pos_of_state: np.ndarray  # (S_sent,) int32 word position in the sentence


def _topology(sentence: str, state_counts: Dict[str, int], label_index: Dict[str, int]):
    lab, loc, pos = [], [], []
    for p, word in enumerate(sentence):
        n = state_counts[word]
        lab.extend([label_index[word]] * n)
        loc.extend(range(n))
        pos.extend([p] * n)
    return _SentenceTopology(
        np.asarray(lab, np.int32), np.asarray(loc, np.int32), np.asarray(pos, np.int32)
    )


def _entry_exit(pos: np.ndarray):
    """(S_sent,) word positions -> (is_entry, is_exit) bool masks: the first
    and last state of every word instance."""
    s = len(pos)
    is_entry = np.zeros(s, bool)
    is_exit = np.zeros(s, bool)
    for p in range(pos.max() + 1):
        idx = np.where(pos == p)[0]
        is_entry[idx[0]] = True
        is_exit[idx[-1]] = True
    return is_entry, is_exit


def _sentence_log_a(
    topo: _SentenceTopology, log_a_g: np.ndarray, cross_word: str = "exit_only"
) -> np.ndarray:
    """Gather per-word transitions onto the sentence state space.

    cross_word="band": every cross-word pair inside the Viterbi band is free
    (log 1 = 0), reproducing the reference's sparse-matrix default
    (transition_probability.py:17-23).
    cross_word="exit_only": only word-exit -> next-word-entry is free, the
    decoder's actual topology (see ContinuousTrainConfig.cross_word).
    The skip-2 band itself is applied inside the banded Viterbi."""
    pos = topo.pos_of_state
    same_word = pos[:, None] == pos[None, :]
    lab = topo.lab_of_state
    loc = topo.loc_of_state
    gathered = log_a_g[lab[:, None], loc[:, None], loc[None, :]]
    if cross_word == "band":
        return np.where(same_word, gathered, 0.0).astype(np.float32)
    is_entry, is_exit = _entry_exit(pos)
    next_word = pos[None, :] == pos[:, None] + 1
    allowed_cross = is_exit[:, None] & is_entry[None, :] & next_word
    out = np.where(same_word, gathered, -np.inf)
    return np.where(allowed_cross, 0.0, out).astype(np.float32)


def _pool_np(stat: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Host-side tie pooling (the legacy spine's analogue of
    train_fused._pool_slots): scatter-add a leading-axis statistic over tie
    groups and broadcast group totals back to member rows."""
    flat = stat.reshape(ids.shape[0], -1)
    pooled = np.zeros_like(flat)
    np.add.at(pooled, ids, flat)
    return pooled[ids].reshape(stat.shape)


def _along_path(paths, *tables):
    """Each (S_sent,) per-sentence-state table read along the (B, T) paths,
    as int64 on the paths' device."""
    path_l = paths.to(torch.int64)
    return [torch.as_tensor(np.asarray(x), device=paths.device).to(torch.int64)[path_l]
            for x in tables]


def _stats_pass(
    means_sent, covs_sent, log_a_sent, lab_of_state, loc_of_state, pos_of_state,
    batch, lengths, num_labels: int, s_max: int,
):
    """Alignment + zeroth/first-order stats + within-segment transition counts
    of one transcript's padded batch (B, T, D), on the batch's device.

    Returns (counts (L, S), sums (L, S, D), trans (L, S, S), paths (B, T)):
    counts and trans are sums of integer one-hots (exact histograms, no
    atomics), returned as float32; sums a float32 one-hot matmul."""
    fp32_exact()
    dev = batch.device
    b, t, d = batch.shape
    f = num_labels * s_max
    params = make_gaussian_params(means_sent, covs_sent, device=dev)
    log_b = gaussian_log_pdf(params, batch)
    _scores, paths = viterbi_banded_batch(
        log_b, torch.as_tensor(log_a_sent, device=dev), lengths)

    mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    lab, loc, pos = _along_path(paths, lab_of_state, loc_of_state, pos_of_state)
    flat = lab * s_max + loc
    oh = torch.nn.functional.one_hot(flat, f) * mask[..., None]  # int64
    counts = oh.sum(dim=(0, 1)).to(torch.float32)
    sums = oh.to(torch.float32).reshape(b * t, f).T @ batch.reshape(b * t, d)

    # Transition counts within word instances: pair (t-1, t) counts iff both
    # frames are real and belong to the same sentence position.
    pair_live = (torch.arange(t - 1, device=dev)[None, :] < (lengths[:, None] - 1)) & (
        pos[:, :-1] == pos[:, 1:])
    from_flat = lab[:, :-1] * (s_max * s_max) + loc[:, :-1] * s_max + loc[:, 1:]
    oh_pair = torch.nn.functional.one_hot(from_flat, f * s_max) * pair_live[..., None]
    trans = oh_pair.sum(dim=(0, 1)).to(torch.float32)
    return (counts.reshape(num_labels, s_max), sums.reshape(num_labels, s_max, d),
            trans.reshape(num_labels, s_max, s_max), paths)


def _m2_per_slot(weights, batch, means_flat):
    """sum over frames of w[slot] (x - mean[slot])(x - mean[slot])^T, one
    slot at a time: weights (B*T, F), batch (B*T, D), means (F, D) ->
    (F, D, D)."""
    f = weights.shape[1]
    d = batch.shape[1]
    m2 = torch.empty((f, d, d), dtype=torch.float32, device=batch.device)
    for slot in range(f):
        centered = batch - means_flat[slot]
        m2[slot] = (centered * weights[:, slot, None]).T @ centered
    return m2


def _centered_m2_pass(
    means_g, lab_of_state, loc_of_state, batch, lengths, paths,
    num_labels: int, s_max: int,
):
    """Pass B: centered second moments around the NEW means (np.cov parity)
    -> (L, S, D, D)."""
    b, t, d = batch.shape
    f = num_labels * s_max
    lab, loc = _along_path(paths, lab_of_state, loc_of_state)
    flat = lab * s_max + loc
    mask = torch.arange(t, device=batch.device)[None, :] < lengths[:, None]
    oh = torch.nn.functional.one_hot(flat, f).to(torch.float32) * mask[..., None]
    means = torch.as_tensor(means_g, dtype=torch.float32, device=batch.device)
    m2 = _m2_per_slot(oh.reshape(b * t, f), batch.reshape(b * t, d), means.reshape(f, d))
    return m2.reshape(num_labels, s_max, d, d)


def _stats_pass_bw(
    means_sent, covs_sent, log_a_sent, lab_of_state, loc_of_state, pos_of_state,
    batch, lengths, num_labels: int, s_max: int,
):
    """Baum-Welch analogue of _stats_pass: forward-backward posteriors over
    the banded sentence topology (ops/forward_backward.py, termination
    pinned to the last state) replace the hard Viterbi one-hots.

    Returns (counts (L, S), sums (L, S, D), trans (L, S, S),
    gamma_f (B, T, L*S) slot posteriors for the covariance pass, total
    loglik)."""
    fp32_exact()
    dev = batch.device
    s_sent = len(lab_of_state)
    f = num_labels * s_max
    params = make_gaussian_params(means_sent, covs_sent, device=dev)
    log_b = gaussian_log_pdf(params, batch)
    trans_eff = banded_transition_matrix(torch.as_tensor(log_a_sent, device=dev))
    log_init = torch.full((s_sent,), NEG, dtype=torch.float32, device=dev)
    log_init[0] = 0.0
    log_final = torch.full((s_sent,), NEG, dtype=torch.float32, device=dev)
    log_final[s_sent - 1] = 0.0
    gamma, xi, ll = forward_backward(log_b, trans_eff, log_init, lengths,
                                     log_final=log_final)
    flat = torch.as_tensor(np.asarray(lab_of_state) * s_max + np.asarray(loc_of_state),
                           device=dev).to(torch.int64)
    slot_map = torch.nn.functional.one_hot(flat, f).to(torch.float32)  # (S_sent, F)
    pos = torch.as_tensor(np.asarray(pos_of_state), device=dev)
    same_pos = (pos[:, None] == pos[None, :]).to(torch.float32)
    b, t, d = batch.shape
    gamma_f = gamma @ slot_map  # (B, T, F)
    counts = gamma_f.sum(dim=(0, 1))
    sums = gamma_f.reshape(b * t, f).T @ batch.reshape(b * t, d)
    trans_f = slot_map.T @ (xi * same_pos).sum(dim=0) @ slot_map  # (F, F)
    trans4 = trans_f.reshape(num_labels, s_max, num_labels, s_max)
    lidx = torch.arange(num_labels, device=dev)
    trans = trans4[lidx, :, lidx, :]  # within-word blocks only
    return (counts.reshape(num_labels, s_max), sums.reshape(num_labels, s_max, d),
            trans, gamma_f, ll.sum())


def _centered_m2_pass_weighted(
    means_g, gamma_f, batch, lengths, num_labels: int, s_max: int,
):
    """Pass B for Baum-Welch: gamma-weighted centered second moments around
    the NEW means (mirrors _centered_m2_pass with soft weights)
    -> (L, S, D, D)."""
    b, t, d = batch.shape
    f = num_labels * s_max
    mask = (torch.arange(t, device=batch.device)[None, :] < lengths[:, None])
    w_all = (gamma_f * mask[..., None]).reshape(b * t, f)
    means = torch.as_tensor(means_g, dtype=torch.float32, device=batch.device)
    m2 = _m2_per_slot(w_all, batch.reshape(b * t, d), means.reshape(f, d))
    return m2.reshape(num_labels, s_max, d, d)


class ContinuousTrainer:
    """Embedded re-estimation of word (+ silence) models from transcripts,
    on ``device`` (the first card by default; ``device="cpu"`` for the
    CPU), or on this rank's device of ``mesh``."""

    def __init__(
        self,
        models: Dict[str, WordHMM],
        cfg: ContinuousTrainConfig = ContinuousTrainConfig(),
        mesh=None,
        state_ties: Dict[tuple, object] | None = None,
        transition_ties: Dict[str, object] | None = None,
        device=None,
    ) -> None:
        """state_ties: optional (label, state) -> group key. Slots sharing a
        group key pool their emission statistics before every M-step and so
        train as ONE shared Gaussian (senone-style state tying). Slots not
        mentioned stay untied. transition_ties: optional label -> group key;
        tied labels (which must have equal state counts) pool transition
        counts and share one transition matrix. A resumed trainer must be
        constructed with the same ties.

        mesh: optional data-parallel mesh (parallel/data_parallel.make_mesh):
        every rank constructs the trainer alike and calls train() with the
        same corpus; each aligns its block of utterances and the statistics
        are summed over the ranks (replacing the reference's per-transcript
        process pool, hidden_markov_model.py:746-750). The trainer runs on
        the rank's mesh device, which an explicit device= must name. Requires
        cfg.fused (the default); only rank 0 writes save_state's file."""
        from ..parallel.data_parallel import site_device
        from .stacking import stack_models  # deferred: stacking imports us
        from .train_fused import tie_plan

        if cfg.update not in ("viterbi", "baum_welch"):
            raise ValueError(
                f"update={cfg.update!r} is not one of 'viterbi'/'baum_welch'"
            )
        if mesh is not None and not cfg.fused:
            raise ValueError(
                "fused=False is the single-host parity oracle (kept as an "
                "independent implementation for tests/benchmarks); mesh "
                "training requires fused=True (the default)"
            )
        self.cfg = cfg
        self.mesh = mesh
        self.device = (site_device(mesh, device) if mesh is not None
                       else resolve_device(device))
        fp32_exact()
        self._iterations_done = 0
        # Final-iteration starvation report: filled by the device-loop spine
        # after train(); [] means every used slot saw frames. frozen labels =
        # labels whose EVERY state went empty (those word models never left
        # their boot init).
        self.last_empty_slots: List[list] = []
        self.last_frozen_labels: List[str] = []
        self._dev_state = None  # device-resident (means, covs, log_a)
        stacked = stack_models(models)
        self.labels: List[str] = stacked.labels
        self.label_index = stacked.label_index
        self.state_counts = stacked.state_counts
        self.s_max = stacked.s_max
        self.dim = stacked.dim
        # Stacked global parameters, padded to s_max states per label — the
        # host mirror of the device state (see _sync_from_device).
        self.means_g = stacked.means
        self.covs_g = stacked.covariances
        self.log_a_g = stacked.log_a
        self._tie_flat = self._build_state_ties(state_ties)
        self._trans_tie = self._build_transition_ties(transition_ties)
        self._conv_tie = self._build_convergence_groups(
            state_ties, transition_ties
        )
        # The fused iterations' fixed-order pooling plans (train_fused.TiePlan).
        self._tie_plans = tuple(tie_plan(t, self.device)
                                for t in (self._tie_flat, self._trans_tie))

    def _build_state_ties(self, state_ties) -> np.ndarray | None:
        """(label, state) -> key dict into a (L*s_max,) int32 tie map whose
        group ids are each group's smallest member flat index (guaranteeing
        valid, collision-free segment ids); unmapped slots keep their own
        flat index (singleton segments = untied)."""
        if not state_ties:
            return None
        l, s = len(self.labels), self.s_max
        tie = np.arange(l * s, dtype=np.int32)
        groups: Dict[object, List[int]] = {}
        for (label, st), key in state_ties.items():
            if label not in self.label_index:
                raise ValueError(f"state_ties: unknown label {label!r}")
            if not 0 <= st < self.state_counts[label]:
                raise ValueError(
                    f"state_ties: state {st} out of range for {label!r} "
                    f"({self.state_counts[label]} states)"
                )
            groups.setdefault(key, []).append(
                self.label_index[label] * s + st
            )
        for members in groups.values():
            tie[members] = min(members)
        return tie

    def _build_convergence_groups(
        self, state_ties, transition_ties
    ) -> np.ndarray | None:
        """Labels connected through any tie group must freeze together
        (per-label convergence would un-share tied parameters mid-run);
        returns (L,) int32 connected-component ids, or None when untied."""
        if not state_ties and not transition_ties:
            return None
        l = len(self.labels)
        parent = list(range(l))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        def union(i, j):
            parent[find(i)] = find(j)

        groups: Dict[object, List[int]] = {}
        for (label, _st), key in (state_ties or {}).items():
            groups.setdefault(("s", key), []).append(self.label_index[label])
        for label, key in (transition_ties or {}).items():
            groups.setdefault(("t", key), []).append(self.label_index[label])
        for members in groups.values():
            for m in members[1:]:
                union(members[0], m)
        return np.asarray([find(i) for i in range(l)], np.int32)

    def _build_transition_ties(self, transition_ties) -> np.ndarray | None:
        if not transition_ties:
            return None
        l = len(self.labels)
        tie = np.arange(l, dtype=np.int32)
        groups: Dict[object, List[str]] = {}
        for label, key in transition_ties.items():
            if label not in self.label_index:
                raise ValueError(f"transition_ties: unknown label {label!r}")
            groups.setdefault(key, []).append(label)
        for members in groups.values():
            counts = {self.state_counts[m] for m in members}
            if len(counts) > 1:
                raise ValueError(
                    "transition_ties: tied labels must have equal state "
                    f"counts, got {sorted(counts)} for {sorted(members)}"
                )
            idx = [self.label_index[m] for m in members]
            tie[idx] = min(idx)
        return tie

    # -- public ---------------------------------------------------------
    def models(self) -> Dict[str, WordHMM]:
        self._sync_from_device()
        out = {}
        for label in self.labels:
            i = self.label_index[label]
            n = self.state_counts[label]
            out[label] = WordHMM(
                label=label,
                means=self.means_g[i, :n].copy(),
                covariances=self.covs_g[i, :n].copy(),
                log_a=self.log_a_g[i, :n, :n].copy(),
            )
        return out

    def train(
        self,
        labeled_features: Dict[str, Sequence[np.ndarray]],
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
    ) -> int:
        """labeled_features: transcript -> list of (T_i, D) feature arrays.
        Returns the number of iterations run.

        checkpoint_dir: when given, saves resumable trainer state (an .npz,
        see save_state) every `checkpoint_every` iterations; a later trainer
        can continue via `resume(checkpoint_dir)`."""
        from ..parallel.data_parallel import mesh_size
        from .train_fused import prepare_fused_corpus

        if self.means_g.ndim != 3:
            raise ValueError(
                "ContinuousTrainer trains single-Gaussian word models; these "
                "models carry mixture weights: train them with "
                "GMMContinuousTrainer (models/train_continuous_gmm.py)")
        use_fused = self.cfg.fused
        if use_fused:
            # Frame padding at 32 granularity: the fused iteration is
            # topology-independent, so a coarser multiple would only add
            # trellis steps.
            batches = prepare_fused_corpus(
                labeled_features, self.state_counts, self.label_index,
                insert_silence if self.cfg.insert_silence else (lambda s: s),
                min(self.cfg.length_multiple, 32), device=self.device,
                num_shards=mesh_size(self.mesh) if self.mesh is not None else 1,
            )
        else:
            batches = self._prepare_batches(labeled_features)
        # The bootstrap applies whenever silence is IN the training topology:
        # interleaved automatically (insert_silence=True), or written
        # explicitly into the transcripts.
        silence_in_topology = self.cfg.insert_silence or any(
            self.cfg.silence_label in tuple(tr) for tr in labeled_features
        )
        if self._iterations_done == 0 and (
            self.cfg.silence_bootstrap
            and silence_in_topology
            and self.cfg.silence_label in self.label_index
        ):
            if use_fused:
                self._bootstrap_silence_fused(batches)
            else:
                self._bootstrap_silence(batches)
        # Device loop: with no per-iteration host work (no checkpointing,
        # empty-slot policy "keep") the remaining run goes through
        # fused_train_run, which reads back one flag per iteration.
        if use_fused and checkpoint_dir is None and self.cfg.on_empty_state == "keep":
            return self._train_device_loop(batches)
        it = self._iterations_done
        for it in range(self._iterations_done + 1, self.cfg.max_iterations + 1):
            all_converged = (self._iteration_fused(batches) if use_fused
                             else self._iteration(batches))
            self._iterations_done = it
            if checkpoint_dir and (it % checkpoint_every == 0 or all_converged):
                self.save_state(checkpoint_dir)
            if all_converged:
                logger.info("continuous training converged after %d iterations", it)
                break
        self._sync_from_device()
        return it

    def _train_device_loop(self, fused) -> int:
        from .train_fused import fused_train_run, fused_train_run_sharded

        remaining = self.cfg.max_iterations - self._iterations_done
        if remaining <= 0:
            return self._iterations_done
        means, covs, log_a, counts, n_it, converged = self._on_mesh(
            fused_train_run, fused_train_run_sharded, fused,
            max_iterations=int(remaining), update=self.cfg.update)
        self._dev_state = (means, covs, log_a)
        counts = counts.cpu().numpy()
        empty = self._slot_used() & (counts < self._count_floor())
        # Machine-readable: which (label, state) slots never saw a frame in
        # the final iteration (kept previous params), and which whole labels
        # that freezes.
        self.last_empty_slots = np.argwhere(empty).tolist()
        self.last_frozen_labels = [
            lab for li, lab in enumerate(self.labels)
            if empty[li, : self.state_counts[lab]].all()
        ]
        if np.any(empty):
            logger.warning(
                "final iteration left empty (label, state) slots (kept "
                "previous params): %s", self.last_empty_slots,
            )
        self._iterations_done += int(n_it)
        if converged:
            logger.info(
                "continuous training converged after %d iterations",
                self._iterations_done,
            )
        self._sync_from_device()
        return self._iterations_done

    # -- resumable state ---------------------------------------------------
    def save_state(self, folder: str) -> None:
        """Resumable trainer state in ``folder``; over a mesh, rank 0
        writes it (every rank holds the same parameters)."""
        from ..parallel.data_parallel import mesh_rank
        from ..utils.checkpoint import save_trainer_state

        self._sync_from_device()
        if self.mesh is not None and mesh_rank(self.mesh) != 0:
            return
        save_trainer_state(
            {
                "means_g": self.means_g,
                "covs_g": self.covs_g,
                "log_a_g": self.log_a_g,
                "iterations_done": np.int32(self._iterations_done),
            },
            folder,
        )

    def resume(self, folder: str) -> int:
        """Load state saved by save_state; returns the iteration to continue
        from. Label set/state counts must match the constructor's models."""
        from ..utils.checkpoint import load_trainer_state

        state = load_trainer_state(folder)
        if state["means_g"].shape != self.means_g.shape:
            raise ValueError(
                f"checkpoint shape {state['means_g'].shape} does not match "
                f"trainer {self.means_g.shape}"
            )
        self.means_g = np.asarray(state["means_g"], np.float32)
        self.covs_g = np.asarray(state["covs_g"], np.float32)
        self.log_a_g = np.asarray(state["log_a_g"], np.float32)
        self._invalidate_device_state()
        self._iterations_done = int(state["iterations_done"])
        logger.info("resumed continuous training at iteration %d",
                    self._iterations_done)
        return self._iterations_done

    # -- fused path (models/train_fused.py) ----------------------------------
    #
    # Parameters live ON the device across fused iterations (self._dev_state);
    # each iteration feeds the previous iteration's outputs straight back in
    # and the host reads only the per-slot counts and per-label convergence
    # flags. The numpy mirrors (means_g/covs_g/log_a_g) are refreshed lazily
    # via _sync_from_device — any code that writes the numpy arrays directly
    # must call _invalidate_device_state.
    def _count_floor(self) -> float:
        """Slot count below which a slot is empty: one frame (Viterbi), the
        soft-count floor (Baum-Welch)."""
        from .train_fused import _BW_FLOOR

        return _BW_FLOOR if self.cfg.update == "baum_welch" else 1.0

    def _slot_used(self) -> np.ndarray:
        l, s = len(self.labels), self.s_max
        slot_used = np.zeros((l, s), bool)
        for label, i in self.label_index.items():
            slot_used[i, : self.state_counts[label]] = True
        return slot_used

    def _tensor(self, x, dtype):
        return None if x is None else torch.as_tensor(x, dtype=dtype,
                                                      device=self.device)

    def _fused_args(self, fused):
        means, covs, log_a = self._device_state()
        return (
            means, covs, log_a, self._tensor(self._slot_used(), torch.bool),
            fused.lab_tab, fused.loc_tab, fused.pos_tab,
            fused.samew_tab, fused.cross_tab, fused.n_states_t,
            fused.batch, fused.lengths, fused.topo_id,
        )

    def _fused_kwargs(self):
        return dict(
            cov_reg=float(self.cfg.cov_reg), rtol=float(self.cfg.rtol),
            atol=float(self.cfg.atol),
            num_labels=len(self.labels), s_max=self.s_max,
            cross_word=self.cfg.cross_word, emissions=self.cfg.emissions,
            tie_flat=self._tie_plans[0], trans_tie=self._tie_plans[1],
            conv_tie=self._tensor(self._conv_tie, torch.int64),
        )

    def _device_state(self):
        if self._dev_state is None:
            self._dev_state = tuple(
                self._tensor(x, torch.float32)
                for x in (self.means_g, self.covs_g, self.log_a_g)
            )
        return self._dev_state

    def _invalidate_device_state(self) -> None:
        self._dev_state = None

    def _sync_from_device(self) -> None:
        if self._dev_state is not None:
            means, covs, log_a = self._dev_state
            self.means_g = means.cpu().numpy().astype(np.float32)
            self.covs_g = covs.cpu().numpy().astype(np.float32)
            self.log_a_g = log_a.cpu().numpy().astype(np.float32)

    def _on_mesh(self, single, sharded, fused, **kw):
        """single(...) on the trainer's device, or sharded(..., mesh) over
        the trainer's mesh."""
        if self.mesh is None:
            return single(*self._fused_args(fused), **self._fused_kwargs(), **kw)
        return sharded(*self._fused_args(fused), self.mesh, **self._fused_kwargs(), **kw)

    def _run_fused(self, fused):
        from .train_fused import fused_viterbi_iteration, fused_viterbi_iteration_sharded

        return self._on_mesh(fused_viterbi_iteration, fused_viterbi_iteration_sharded, fused)

    def _run_fused_bw(self, fused):
        from .train_fused import fused_bw_iteration, fused_bw_iteration_sharded

        return self._on_mesh(fused_bw_iteration, fused_bw_iteration_sharded, fused)

    def _iteration_fused(self, fused) -> bool:
        run = self._run_fused_bw if self.cfg.update == "baum_welch" else self._run_fused
        new_means, new_covs, new_log_a, counts, converged_l, _ = run(fused)
        counts = counts.cpu().numpy()
        converged_l = converged_l.cpu().numpy()
        empty = self._slot_used() & (counts < self._count_floor())
        if np.any(empty):
            bad = np.argwhere(empty).tolist()
            if self.cfg.on_empty_state == "fail":
                raise HMMTrainMeanFail(f"(label, state) slots with no frames: {bad}")
            logger.warning("keeping previous params for empty slots: %s", bad)
        if converged_l.all():
            return True
        # Keep-old masks (empty slots, converged labels) are already applied
        # in the iteration; the outputs ARE the next iteration's state.
        self._dev_state = (new_means, new_covs, new_log_a)
        return False

    def _bootstrap_silence_fused(self, fused) -> None:
        """Re-estimate the silence model from long in-context S-aligned runs
        (digits frozen): one alignment, then segmental k-means of S alone.
        See ContinuousTrainConfig.silence_bootstrap."""
        sil = self.cfg.silence_label
        i_s = self.label_index[sil]
        n_s = self.state_counts[sil]
        min_run = self.cfg.silence_bootstrap_min_run
        *_rest, paths = self._run_fused(fused)
        paths = paths.cpu().numpy()
        n_chunks, c, t = paths.shape
        paths = paths.reshape(n_chunks * c, t)
        batch_np = fused.batch.cpu().numpy().reshape(n_chunks * c, t, -1)
        lengths_np = fused.lengths.cpu().numpy().reshape(-1)
        topo_id = fused.topo_id.cpu().numpy().reshape(-1)
        lab_tab = fused.lab_tab.cpu().numpy()
        runs: List[np.ndarray] = []
        for b in range(fused.num_utts):
            lab_path = lab_tab[topo_id[b]][paths[b, : lengths_np[b]]]
            is_sil = lab_path == i_s
            bounds = np.where(np.diff(is_sil.astype(int)) != 0)[0] + 1
            for seg in np.split(np.arange(lengths_np[b]), bounds):
                if len(seg) >= min_run and is_sil[seg[0]]:
                    runs.append(batch_np[b, seg])
        if len(runs) < 3:
            logger.warning("silence bootstrap skipped: only %d runs", len(runs))
            return
        result = train_word_hmm(
            sil, runs,
            SegmentalKMeansConfig(
                num_states=n_s,
                max_iterations=min(self.cfg.max_iterations, 15),
                length_multiple=32,
            ),
            device=self.device,
        )
        self.means_g[i_s, :n_s] = result.model.means
        self.covs_g[i_s, :n_s] = result.model.covariances
        self.log_a_g[i_s, :n_s, :n_s] = result.model.log_a
        self._invalidate_device_state()
        logger.info("silence bootstrap: retrained %s on %d runs", sil, len(runs))

    # -- legacy per-transcript path (fused=False) -----------------------------
    def _prepare_batches(self, labeled_features):
        """One padded batch per transcript, on the trainer's device."""
        batches = []
        for transcript, feats in labeled_features.items():
            sentence = (
                insert_silence(transcript) if self.cfg.insert_silence else transcript
            )
            topo = _topology(sentence, self.state_counts, self.label_index)
            padded = pad_batch(list(feats), self.cfg.length_multiple)
            batches.append({
                "sentence": sentence,
                "topo": topo,
                "batch": torch.as_tensor(padded.data, device=self.device),
                "lengths": torch.as_tensor(padded.lengths, device=self.device),
            })
        return batches

    def _sentence_args(self, topo):
        """The transcript's gathered (means, covs, log_a) and state tables."""
        return (
            self.means_g[topo.lab_of_state, topo.loc_of_state],
            self.covs_g[topo.lab_of_state, topo.loc_of_state],
            _sentence_log_a(topo, self.log_a_g, self.cfg.cross_word),
            topo.lab_of_state, topo.loc_of_state, topo.pos_of_state,
        )

    def _bootstrap_silence(self, batches) -> None:
        """Re-estimate the silence model from long in-context S-aligned runs
        (digits frozen), aligning transcript by transcript. See
        ContinuousTrainConfig.silence_bootstrap."""
        sil = self.cfg.silence_label
        i_s = self.label_index[sil]
        n_s = self.state_counts[sil]
        min_run = self.cfg.silence_bootstrap_min_run
        runs: List[np.ndarray] = []
        for item in batches:
            topo = item["topo"]
            *_stats, paths = _stats_pass(
                *self._sentence_args(topo), item["batch"], item["lengths"],
                len(self.labels), self.s_max,
            )
            paths = paths.cpu().numpy()
            batch_np = item["batch"].cpu().numpy()
            lengths_np = item["lengths"].cpu().numpy()
            lab_path = topo.lab_of_state[paths]
            for b in range(paths.shape[0]):
                is_sil = lab_path[b, : lengths_np[b]] == i_s
                bounds = np.where(np.diff(is_sil.astype(int)) != 0)[0] + 1
                for seg in np.split(np.arange(lengths_np[b]), bounds):
                    if len(seg) >= min_run and is_sil[seg[0]]:
                        runs.append(batch_np[b, seg])
        if len(runs) < 3:
            logger.warning("silence bootstrap skipped: only %d runs", len(runs))
            return
        result = train_word_hmm(
            sil, runs,
            SegmentalKMeansConfig(
                num_states=n_s,
                max_iterations=min(self.cfg.max_iterations, 15),
                length_multiple=32,
            ),
            device=self.device,
        )
        self.means_g[i_s, :n_s] = result.model.means
        self.covs_g[i_s, :n_s] = result.model.covariances
        self.log_a_g[i_s, :n_s, :n_s] = result.model.log_a
        self._invalidate_device_state()
        logger.info("silence bootstrap: retrained %s on %d runs", sil, len(runs))

    def _iteration(self, batches) -> bool:
        """Legacy per-transcript iteration — the independently implemented
        parity oracle for the fused iteration (float64 host-side statistics,
        one statistics pass and one covariance pass per transcript)."""
        l, s, d = self.means_g.shape[0], self.s_max, self.dim
        baum_welch = self.cfg.update == "baum_welch"
        count_floor = self._count_floor()
        counts = np.zeros((l, s), np.float64)
        sums = np.zeros((l, s, d), np.float64)
        trans = np.zeros((l, s, s), np.float64)
        weights_per_batch = []  # Viterbi: paths; BW: gamma_f slot posteriors
        for item in batches:
            stats_pass = _stats_pass_bw if baum_welch else _stats_pass
            c, sm, tr, weights, *_ll = stats_pass(
                *self._sentence_args(item["topo"]), item["batch"], item["lengths"], l, s)
            weights_per_batch.append(weights)
            counts += c.cpu().numpy().astype(np.float64)
            sums += sm.cpu().numpy().astype(np.float64)
            trans += tr.cpu().numpy().astype(np.float64)

        if self._tie_flat is not None:
            counts = _pool_np(counts.reshape(l * s), self._tie_flat).reshape(l, s)
            sums = _pool_np(sums.reshape(l * s, d), self._tie_flat).reshape(l, s, d)
        if self._trans_tie is not None:
            trans = _pool_np(trans, self._trans_tie)

        slot_used = self._slot_used()
        empty = slot_used & (counts < count_floor)
        if np.any(empty):
            bad = np.argwhere(empty).tolist()
            if self.cfg.on_empty_state == "fail":
                raise HMMTrainMeanFail(f"(label, state) slots with no frames: {bad}")
            logger.warning("keeping previous params for empty slots: %s", bad)

        new_means = (
            sums / np.maximum(counts, count_floor)[..., None]
        ).astype(np.float32)
        new_means = np.where(empty[..., None], self.means_g, new_means)

        # Per-label convergence on means (reference allclose, :333).
        converged = np.array([
            np.allclose(new_means[i][slot_used[i]], self.means_g[i][slot_used[i]],
                        rtol=self.cfg.rtol, atol=self.cfg.atol)
            for i in range(l)
        ])
        if self._conv_tie is not None:
            # Tie-connected labels freeze together (same rule as the fused
            # bodies).
            bad = np.zeros(l, np.int64)
            np.add.at(bad, self._conv_tie, (~converged).astype(np.int64))
            converged = bad[self._conv_tie] == 0
        if converged.all():
            return True

        # Pass B: centered covariance around the new means.
        m2 = np.zeros((l, s, d, d), np.float64)
        for item, weights in zip(batches, weights_per_batch):
            topo = item["topo"]
            if baum_welch:
                part = _centered_m2_pass_weighted(
                    new_means, weights, item["batch"], item["lengths"], l, s)
            else:
                part = _centered_m2_pass(
                    new_means, topo.lab_of_state, topo.loc_of_state,
                    item["batch"], item["lengths"], weights, l, s)
            m2 += part.cpu().numpy().astype(np.float64)
        if self._tie_flat is not None:
            # Tied slots share new_means, so pooled centered moments give the
            # exact group covariance under either denominator.
            m2 = _pool_np(m2.reshape(l * s, d, d), self._tie_flat).reshape(l, s, d, d)
        # Viterbi keeps the reference's np.cov ddof=1 denominator; soft counts
        # use the standard ML normalization.
        denom = (np.maximum(counts, count_floor) if baum_welch
                 else np.maximum(counts - 1.0, 1.0))[..., None, None]
        new_covs = (m2 / denom + self.cfg.cov_reg * np.eye(d)).astype(np.float32)
        new_covs = np.where(empty[..., None, None], self.covs_g, new_covs)

        row_sums = trans.sum(axis=2, keepdims=True)
        probs = trans / np.maximum(row_sums, count_floor)
        with np.errstate(divide="ignore"):
            new_log_a = np.where(probs > 0, np.log(probs), -np.inf).astype(np.float32)
        # Rows with no observed outgoing transitions keep their previous row
        # (an -inf row would make the state a trap).
        no_out = (row_sums[..., 0] < count_floor) & slot_used
        new_log_a = np.where(no_out[..., None], self.log_a_g, new_log_a)

        # Converged models keep their parameters this iteration (the reference
        # raises before assignment, hidden_markov_model.py:333-335).
        upd = ~converged
        self.means_g[upd] = new_means[upd]
        self.covs_g[upd] = new_covs[upd]
        self.log_a_g[upd] = new_log_a[upd]
        # Padded slots keep identity covariance so Cholesky stays valid.
        self.covs_g[~slot_used] = np.eye(d, dtype=np.float32)
        return False
