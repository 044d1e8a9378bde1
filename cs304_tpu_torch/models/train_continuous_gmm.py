"""Embedded continuous training with K-mixture GMM emissions.

A port of cs304_tpu/models/train_continuous_gmm.py (one device, or a
data-parallel mesh through the *_sharded entry points). GMM
emissions drop into the fused embedded-training design of
models/train_fused.py: one iteration aligns the whole corpus with the
sentence trellis under the GMM emission densities (hard state assignment;
on a card one launch of K3's sentence decode mode, bitwise its plain
version), then splits each frame between the mixtures of its assigned state
by SOFT responsibilities, and re-estimates means, weights, covariances and
transitions on the device. K = 1 reduces exactly to the single-Gaussian
fused trainer.

The usual flow: train K = 1 models with ContinuousTrainer, ``promote_to_gmm``
them (mean splitting with jitter), then refine here.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import fp32_exact, resolve_device
from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.logmath import logsumexp
from .gmm_hmm import GMMWordHMM
from .hmm import WordHMM
from .train_continuous import HMMTrainMeanFail, insert_silence
from .train_fused import (
    NEG,
    _histogram,
    _identity,
    _sentence_trans_diagonals,
    _sharded,
    _training_trellis,
    prepare_fused_corpus,
)

logger = logging.getLogger(__name__)


def promote_to_gmm(
    models: Dict[str, WordHMM | GMMWordHMM],
    num_mixtures: int,
    jitter: float = 1.0,
    seed: int = 0,
) -> Dict[str, GMMWordHMM]:
    """Split trained single-Gaussian models into K mixtures (VQ-style mixup).

    The first two mixtures start at mean +/- jitter * std (per-dimension std
    from the state's own covariance diagonal), further ones (K > 2) at
    independent N(0, (jitter * std)^2) offsets. Covariances are shared
    copies; weights start uniform. Models already GMMWordHMM pass through
    unchanged (K must match)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, GMMWordHMM] = {}
    for label, m in models.items():
        if isinstance(m, GMMWordHMM):
            if m.num_mixtures != num_mixtures:
                raise ValueError(
                    f"model {label!r} has K={m.num_mixtures}, expected {num_mixtures}")
            out[label] = m
            continue
        s, d = m.means.shape
        std = np.sqrt(np.maximum(np.diagonal(m.covariances, axis1=-2, axis2=-1), 1e-8))
        offsets = np.zeros((s, num_mixtures, d), np.float32)
        if num_mixtures >= 2:
            offsets[:, 0] = jitter * std
            offsets[:, 1] = -jitter * std
        for k_i in range(2, num_mixtures):
            offsets[:, k_i] = rng.normal(0, jitter, size=(s, d)) * std
        out[label] = GMMWordHMM(
            label=label,
            means=(m.means[:, None, :] + offsets).astype(np.float32),
            covariances=np.tile(m.covariances[:, None], (1, num_mixtures, 1, 1)).astype(
                np.float32),
            weights=np.full((s, num_mixtures), 1.0 / num_mixtures, np.float32),
            log_a=m.log_a.copy(),
        )
    return out


def _gmm_emissions(params, log_w, batch, lab_tab, loc_tab, topo_id, s_max: int, k: int):
    """Weighted component log-densities of every (slot, mixture) and the GMM
    emissions gathered per sentence state, one chunk of utterances at a time
    (the (frames, F*K, D) whitening intermediate is the iteration's largest
    tensor) -> (comp (n_chunks, C, T, F, K), lb_sent (n_chunks, C, T, S_sent))."""
    n_chunks, c, t, d = batch.shape
    f = log_w.shape[0]
    flat_slot = lab_tab.to(torch.int64) * s_max + loc_tab.to(torch.int64)
    ss = flat_slot.shape[1]
    comps, lbs = [], []
    for i in range(n_chunks):
        comp = gaussian_log_pdf(params, batch[i].reshape(c * t, d)).reshape(c, t, f, k) + log_w
        lb_slots = logsumexp(comp, axis=-1)  # (C, T, F)
        fs = flat_slot[topo_id[i].to(torch.int64)]  # (C, S_sent)
        lbs.append(lb_slots.gather(2, fs[:, None, :].expand(c, t, ss)))
        comps.append(comp)
    return torch.stack(comps), torch.stack(lbs)


def _gmm_body(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    *, cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str,
    reduce_fn=_identity,
):
    """One embedded GMM iteration on the tensors' device; reduce_fn sums
    the statistics over a mesh where the JAX body psums them (counts, sums
    and transition counts after pass A, the second moments after pass B).

    Shapes: means_g (L, S, K, D), covs_g (L, S, K, D, D), weights_g (L, S, K).
    Returns (new_means, new_covs, new_weights, new_log_a, counts (L, S, K),
    converged_l (L,), paths (n_chunks, C, T)). The M-step conventions are the
    fused single-Gaussian trainer's (np.cov ddof=1 denominator, empty-slot and
    converged-label keep-old); empty MIXTURES also keep their previous
    parameters. The covariance uses the Koenig decomposition around the
    global weighted mean (see train_fused._bw_body)."""
    fp32_exact()
    l, s, k, d = means_g.shape
    f = num_labels * s_max
    fk = f * k
    n_chunks, c, t, _ = batch.shape
    b = n_chunks * c
    dev = batch.device

    params = make_gaussian_params(means_g.reshape(fk, d), covs_g.reshape(fk, d, d))
    log_w = torch.where(weights_g > 0, torch.log(torch.clamp(weights_g, min=1e-38)),
                        torch.full_like(weights_g, NEG)).reshape(f, k)

    # ---- pass 1: GMM emissions per sentence state ----
    comp, lb_sent = _gmm_emissions(params, log_w, batch, lab_tab, loc_tab, topo_id,
                                   s_max, k)
    s_sent = lb_sent.shape[-1]

    # ---- trellis: whole-batch banded sentence Viterbi ----
    topo_flat = topo_id.reshape(b).to(torch.int64)
    lab_u, loc_u, pos_u = lab_tab[topo_flat], loc_tab[topo_flat], pos_tab[topo_flat]
    c0, c1, c2 = _sentence_trans_diagonals(log_a_g, lab_u, loc_u, samew_tab[topo_flat],
                                           cross_tab[topo_flat], cross_word)
    lengths_flat = lengths.reshape(b)
    _scores, paths_flat = _training_trellis(lb_sent.reshape(b, t, s_sent), c0, c1, c2,
                                            lengths_flat, n_states_t[topo_flat])

    # ---- pass A: responsibilities + zeroth/first-order stats + transitions
    path_l = paths_flat.to(torch.int64)
    lab_p = lab_u.to(torch.int64).gather(1, path_l)
    loc_p = loc_u.to(torch.int64).gather(1, path_l)
    pos_p = pos_u.gather(1, path_l)
    flat = lab_p * s_max + loc_p  # (B, T) assigned slot
    mask = torch.arange(t, device=dev)[None, :] < lengths_flat[:, None]
    comp_p = comp.reshape(b, t, f, k).gather(2, flat[..., None, None].expand(b, t, 1, k))[:, :, 0]
    r = torch.softmax(comp_p, dim=-1) * mask[..., None]  # (B, T, K)
    oh = torch.nn.functional.one_hot(flat, f).to(torch.float32) * mask[..., None]
    n = b * t
    counts_fk = oh.reshape(n, f).T @ r.reshape(n, k)  # (F, K)
    rx = (r[..., :, None] * batch.reshape(b, t, 1, d)).reshape(n, k * d)
    sums = (oh.reshape(n, f).T @ rx).reshape(f, k, d)
    pair_live = (torch.arange(t - 1, device=dev)[None, :] < (lengths_flat[:, None] - 1)) & (
        pos_p[:, :-1] == pos_p[:, 1:])
    from_flat = lab_p[:, :-1] * (s_max * s_max) + loc_p[:, :-1] * s_max + loc_p[:, 1:]
    counts_fk = reduce_fn(counts_fk)
    sums = reduce_fn(sums)
    trans = reduce_fn(_histogram(from_flat, pair_live, f * s_max)).to(
        torch.float32).reshape(l, s, s)

    # ---- M-step: means / weights + convergence ----
    counts = counts_fk.reshape(l, s, k)
    slot_used_k = slot_used[..., None]
    empty_mix = slot_used_k & (counts < 1.0)
    new_means = (sums / torch.clamp(counts_fk, min=1.0)[..., None]).reshape(l, s, k, d)
    new_means = torch.where(empty_mix[..., None], means_g, new_means)
    state_tot = counts.sum(dim=-1, keepdim=True)
    new_weights = torch.where(state_tot > 0, counts / torch.clamp(state_tot, min=1.0),
                              weights_g)
    close = torch.abs(new_means - means_g) <= atol + rtol * torch.abs(means_g)
    converged_l = torch.all(close.all(-1).all(-1) | ~slot_used, dim=-1)

    # ---- pass B: covariance (Koenig around the global weighted mean) ----
    new_means_flat = new_means.reshape(fk, d)
    total = torch.clamp(counts_fk.sum(), min=1.0)
    c_glob = sums.reshape(fk, d).sum(dim=0) / total
    d_fk = new_means_flat - c_glob
    w_c = (oh[..., :, None] * r[..., None, :]).reshape(n_chunks, c * t, fk)
    sxx = torch.zeros((fk, d * d), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        xc = batch[i].reshape(c * t, d) - c_glob
        x2 = (xc[:, :, None] * xc[:, None, :]).reshape(c * t, d * d)
        sxx = sxx + w_c[i].T @ x2
    sxx = reduce_fn(sxx)
    m2 = (sxx.reshape(fk, d, d)
          - counts_fk.reshape(fk)[:, None, None] * (d_fk[:, :, None] * d_fk[:, None, :])
          ).reshape(l, s, k, d, d)
    denom = torch.clamp(counts - 1.0, min=1.0)[..., None, None]
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    new_covs = m2 / denom + cov_reg * eye
    new_covs = torch.where(empty_mix[..., None, None], covs_g, new_covs)
    new_covs = torch.where(slot_used_k[..., None, None], new_covs, eye)

    # ---- transitions (state level, as the K = 1 fused trainer) ----
    row_sums = trans.sum(dim=2, keepdim=True)
    probs = trans / torch.clamp(row_sums, min=1.0)
    new_log_a = torch.where(probs > 0, torch.log(probs), torch.full_like(probs, NEG))
    no_out = (row_sums[..., 0] < 1.0) & slot_used
    new_log_a = torch.where(no_out[..., None], log_a_g, new_log_a)

    keep = converged_l[:, None, None]
    new_means = torch.where(keep[..., None], means_g, new_means)
    new_covs = torch.where(keep[..., None, None], covs_g, new_covs)
    new_weights = torch.where(keep, weights_g, new_weights)
    new_log_a = torch.where(keep, log_a_g, new_log_a)
    return (new_means, new_covs, new_weights, new_log_a, counts, converged_l,
            paths_flat.reshape(n_chunks, c, t))


def fused_gmm_iteration(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str = "exit_only",
):
    """One embedded GMM training iteration on the tensors' device (_gmm_body)."""
    return _gmm_body(
        means_g, covs_g, weights_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
        cov_reg=cov_reg, rtol=rtol, atol=atol,
        num_labels=num_labels, s_max=s_max, num_mix=num_mix, cross_word=cross_word,
    )


def fused_gmm_train_run(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str,
    max_iterations: int,
):
    """The remaining embedded GMM refinement: GMM iterations until every
    label converges or max_iterations, one flag read back per iteration
    (the iteration that detects convergence counts, as in the JAX package's
    while loop). Returns (means, covs, weights, log_a, counts, iterations,
    converged); the last two are a Python int and bool."""
    return _gmm_run(
        means_g, covs_g, weights_g, log_a_g, slot_used,
        lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
        batch, lengths, topo_id,
        cov_reg=cov_reg, rtol=rtol, atol=atol, num_labels=num_labels, s_max=s_max,
        num_mix=num_mix, cross_word=cross_word, max_iterations=max_iterations)


def _gmm_run(means_g, covs_g, weights_g, log_a_g, *tables, max_iterations: int,
             num_labels: int, s_max: int, num_mix: int, **kw):
    """fused_gmm_train_run's loop (kw: _gmm_body's keywords, reduce_fn
    among them for the sharded run)."""
    means, covs, weights, log_a = means_g, covs_g, weights_g, log_a_g
    counts = torch.zeros((num_labels, s_max, num_mix), dtype=torch.float32,
                         device=means_g.device)
    it, converged = 0, False
    while it < max_iterations and not converged:
        means, covs, weights, log_a, counts, converged_l, _ = _gmm_body(
            means, covs, weights, log_a, *tables,
            num_labels=num_labels, s_max=s_max, num_mix=num_mix, **kw)
        it += 1
        converged = bool(converged_l.all())
    return means, covs, weights, log_a, counts, it, converged


def fused_gmm_iteration_sharded(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str = "exit_only",
):
    """fused_gmm_iteration over a data-parallel mesh (the sharding of
    train_fused.fused_viterbi_iteration_sharded); the paths are gathered to
    the full (n_chunks, C, T) on every rank."""
    from ..parallel.data_parallel import gather_rows, reducer

    args = (means_g, covs_g, weights_g, log_a_g, slot_used,
            lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
            batch, lengths, topo_id)
    *out, paths = _gmm_body(
        *_sharded(args, mesh),
        cov_reg=cov_reg, rtol=rtol, atol=atol, num_labels=num_labels, s_max=s_max,
        num_mix=num_mix, cross_word=cross_word, reduce_fn=reducer(mesh))
    return (*out, gather_rows(paths, mesh))


def fused_gmm_train_run_sharded(
    means_g, covs_g, weights_g, log_a_g, slot_used,
    lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
    batch, lengths, topo_id, mesh,
    cov_reg: float, rtol: float, atol: float,
    num_labels: int, s_max: int, num_mix: int, cross_word: str,
    max_iterations: int,
):
    """fused_gmm_train_run over a data-parallel mesh: every rank runs the
    same iterations on its block of chunks."""
    from ..parallel.data_parallel import reducer

    args = (means_g, covs_g, weights_g, log_a_g, slot_used,
            lab_tab, loc_tab, pos_tab, samew_tab, cross_tab, n_states_t,
            batch, lengths, topo_id)
    return _gmm_run(
        *_sharded(args, mesh),
        cov_reg=cov_reg, rtol=rtol, atol=atol, num_labels=num_labels, s_max=s_max,
        num_mix=num_mix, cross_word=cross_word, max_iterations=max_iterations,
        reduce_fn=reducer(mesh))


@dataclass(frozen=True)
class GMMContinuousTrainConfig:
    """Embedded GMM refinement configuration (a subset of
    ContinuousTrainConfig: the silence bootstrap belongs to the K = 1 phase)."""

    max_iterations: int = 10
    cov_reg: float = 0.001
    rtol: float = 1e-5
    atol: float = 1e-8
    insert_silence: bool = True
    silence_label: str = "S"
    on_empty_state: str = "keep"  # "keep" | "fail" (empty STATES, not mixtures)
    cross_word: str = "exit_only"
    length_multiple: int = 32


class GMMContinuousTrainer:
    """Embedded re-estimation of K-mixture GMM word models from transcripts,
    on ``device`` (the first card by default; ``device="cpu"`` for the CPU),
    or over a data-parallel ``mesh`` on this rank's mesh device, as
    ContinuousTrainer. The same external shape as ContinuousTrainer (train /
    models)."""

    def __init__(
        self,
        models: Dict[str, GMMWordHMM],
        cfg: GMMContinuousTrainConfig = GMMContinuousTrainConfig(),
        mesh=None,
        device=None,
    ):
        from ..parallel.data_parallel import site_device

        self.cfg = cfg
        self.mesh = mesh
        self.device = (site_device(mesh, device) if mesh is not None
                       else resolve_device(device))
        self.labels: List[str] = sorted(models)
        self.label_index = {lab: i for i, lab in enumerate(self.labels)}
        self.state_counts = {lab: models[lab].num_states for lab in self.labels}
        ks = {models[lab].num_mixtures for lab in self.labels}
        if len(ks) != 1:
            raise ValueError(f"all models must share K, got {sorted(ks)}")
        self.k = ks.pop()
        self.s_max = max(self.state_counts.values())
        self.dim = models[self.labels[0]].means.shape[-1]
        l, s, k, d = len(self.labels), self.s_max, self.k, self.dim
        self.means_g = np.zeros((l, s, k, d), np.float32)
        self.covs_g = np.tile(np.eye(d, dtype=np.float32), (l, s, k, 1, 1))
        self.weights_g = np.full((l, s, k), 1.0 / k, np.float32)
        self.log_a_g = np.full((l, s, s), -np.inf, np.float32)
        for lab in self.labels:
            i, m = self.label_index[lab], models[lab]
            n = m.num_states
            self.means_g[i, :n] = m.means
            self.covs_g[i, :n] = m.covariances
            self.weights_g[i, :n] = m.weights
            self.log_a_g[i, :n, :n] = m.log_a
        self._iterations_done = 0

    def _slot_used(self) -> np.ndarray:
        used = np.zeros((len(self.labels), self.s_max), bool)
        for lab, i in self.label_index.items():
            used[i, : self.state_counts[lab]] = True
        return used

    def models(self) -> Dict[str, GMMWordHMM]:
        out = {}
        for lab in self.labels:
            i, n = self.label_index[lab], self.state_counts[lab]
            out[lab] = GMMWordHMM(
                label=lab,
                means=self.means_g[i, :n].copy(),
                covariances=self.covs_g[i, :n].copy(),
                weights=self.weights_g[i, :n].copy(),
                log_a=self.log_a_g[i, :n, :n].copy(),
            )
        return out

    def _args(self, fused):
        dev = self.device

        def put(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        return (
            put(self.means_g), put(self.covs_g), put(self.weights_g), put(self.log_a_g),
            put(self._slot_used(), torch.bool),
            fused.lab_tab, fused.loc_tab, fused.pos_tab,
            fused.samew_tab, fused.cross_tab, fused.n_states_t,
            fused.batch, fused.lengths, fused.topo_id,
        )

    def _on_mesh(self, single, sharded, fused, **kw):
        if self.mesh is None:
            return single(*self._args(fused), **self._kwargs(), **kw)
        return sharded(*self._args(fused), self.mesh, **self._kwargs(), **kw)

    def _kwargs(self):
        cfg = self.cfg
        return dict(cov_reg=float(cfg.cov_reg), rtol=float(cfg.rtol), atol=float(cfg.atol),
                    num_labels=len(self.labels), s_max=self.s_max, num_mix=self.k,
                    cross_word=cfg.cross_word)

    def _store(self, means, covs, weights, log_a) -> None:
        self.means_g = means.cpu().numpy().astype(np.float32)
        self.covs_g = covs.cpu().numpy().astype(np.float32)
        self.weights_g = weights.cpu().numpy().astype(np.float32)
        self.log_a_g = log_a.cpu().numpy().astype(np.float32)

    def train(self, labeled_features: Dict[str, Sequence[np.ndarray]]) -> int:
        """Run embedded GMM refinement; returns the iterations performed."""
        from ..parallel.data_parallel import mesh_size

        cfg = self.cfg
        fused = prepare_fused_corpus(
            labeled_features, self.state_counts, self.label_index,
            insert_silence if cfg.insert_silence else (lambda x: x),
            cfg.length_multiple,
            # K-mixture emissions scale the whitened intermediate by K;
            # shrink the chunk to keep a chunk's memory at the K = 1 level.
            chunk_utts=max(8, 64 // max(self.k, 1)),
            device=self.device,
            num_shards=mesh_size(self.mesh) if self.mesh is not None else 1,
        )
        if cfg.on_empty_state == "keep":
            # The device loop: one flag read back an iteration ("fail" needs
            # the per-iteration counts on the host, so it keeps the step loop).
            return self._train_device_loop(fused)
        it = self._iterations_done
        for it in range(self._iterations_done + 1, cfg.max_iterations + 1):
            (new_means, new_covs, new_weights, new_log_a, counts, converged_l,
             _paths) = self._on_mesh(fused_gmm_iteration, fused_gmm_iteration_sharded, fused)
            state_tot = counts.cpu().numpy().sum(axis=-1)
            converged_l = converged_l.cpu().numpy()
            empty_states = self._slot_used() & (state_tot < 1)
            if np.any(empty_states):
                bad = np.argwhere(empty_states).tolist()
                if cfg.on_empty_state == "fail":
                    raise HMMTrainMeanFail(f"(label, state) slots with no frames: {bad}")
                logger.warning("empty (label, state) slots kept: %s", bad)
            self._iterations_done = it
            if converged_l.all():
                logger.info("GMM embedded training converged after %d", it)
                return it
            self._store(new_means, new_covs, new_weights, new_log_a)
        return it

    def _train_device_loop(self, fused) -> int:
        remaining = self.cfg.max_iterations - self._iterations_done
        if remaining <= 0:
            return self._iterations_done
        means, covs, weights, log_a, counts, n_it, converged = self._on_mesh(
            fused_gmm_train_run, fused_gmm_train_run_sharded, fused,
            max_iterations=int(remaining))
        state_tot = counts.cpu().numpy().sum(axis=-1)
        empty_states = self._slot_used() & (state_tot < 1)
        if np.any(empty_states):
            logger.warning("final iteration left empty (label, state) slots: %s",
                           np.argwhere(empty_states).tolist())
        self._store(means, covs, weights, log_a)
        self._iterations_done += int(n_it)
        if converged:
            logger.info("GMM embedded training converged after %d iterations",
                        self._iterations_done)
        return self._iterations_done
