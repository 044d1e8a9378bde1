"""Segmental k-means (Viterbi) training of word HMMs, batched.

Reference algorithm (hidden_markov_model.py:211-410):
  init:   means = uniform time-split of the FIRST utterance (:359-385),
          covariances = 0.01 * I (:387-389),
          transitions = row-uniform forward (transition_probability.py:42-52)
  iterate (<=100):
          Viterbi-align every utterance  -> pool frames by state
          means  = per-state frame averages
          covs   = np.cov(state frames, ddof=1) + 0.001 * I  (:341-345)
          trans  = row-normalized transition counts (signal.py:81-91)
          stop when np.allclose(new_means, old_means)  (:333-335)
          a state with zero frames aborts training (HMMTrainMeanFail, :327-329)

The E-step is the banded single-word Viterbi (ops/viterbi.viterbi_banded_batch)
over a padded batch and the M-step is one-hot matmuls, as in
cs304_tpu/models/train_kmeans.py. The model axis of the batched trainer is
spelled out, (M, B, T, D), where the JAX package vmaps; kmeans_step is the
M = 1 case. Convergence and failure are host-side checks on tiny arrays.
Everything is float32 with TF32 off.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..data.batching import pad_batch, round_up
from ..device import fp32_exact, resolve_device
from ..ops.gaussian import make_gaussian_params
from ..ops.viterbi import viterbi_banded_batch
from .hmm import WordHMM, uniform_forward_log_a

logger = logging.getLogger(__name__)

class HMMTrainMeanFail(RuntimeError):
    """A state received zero frames during alignment (reference
    hidden_markov_model.py:214-217); the embedded trainer raises it for a
    used (label, state) slot under on_empty_state="fail"."""


@dataclass(frozen=True)
class SegmentalKMeansConfig:
    num_states: int = 5
    max_iterations: int = 100
    init_cov: float = 0.01
    cov_reg: float = 0.001
    length_multiple: int = 128
    # np.allclose defaults, used for the means convergence test (:333).
    rtol: float = 1e-5
    atol: float = 1e-8


def init_parameters(first_utterance: np.ndarray, cfg: SegmentalKMeansConfig):
    """Uniform time-split init (reference hidden_markov_model.py:359-389)."""
    s = cfg.num_states
    t0, d = first_utterance.shape
    if t0 < s:
        raise ValueError(f"First utterance has {t0} frames < {s} states")
    state_len = t0 // s
    means = np.stack(
        [
            first_utterance[i * state_len : (i + 1) * state_len].mean(axis=0)
            for i in range(s)
        ]
    ).astype(np.float32)
    covs = np.tile(np.eye(d, dtype=np.float32) * cfg.init_cov, (s, 1, 1))
    log_a = uniform_forward_log_a(s)
    return means, covs, log_a


def _one_hot(idx, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx.to(torch.int64), n).to(torch.float32)


def kmeans_step_batched(means, covs, log_a, batch, lengths, num_states: int,
                        cov_reg: float):
    """One E+M iteration of M models at once: means (M, S, D), covs
    (M, S, D, D), log_a (M, S, S), batch (M, B, T, D), lengths (M, B) ->
    (new_means, new_covs, new_log_a, counts (M, S), total_score (M,))."""
    fp32_exact()
    s = num_states
    m, b, t, d = batch.shape
    params = make_gaussian_params(means.reshape(m * s, d),
                                  covs.reshape(m * s, d, d), device=batch.device)
    whiten = params.whiten.reshape(m, s, d, d)
    wx = torch.einsum("msde,mbte->mbtsd", whiten, batch)
    wmu = torch.einsum("msde,mse->msd", whiten, params.means.reshape(m, s, d))
    y = wx - wmu[:, None, None]
    log_b = params.log_norm.reshape(m, 1, 1, s) - 0.5 * torch.sum(y * y, dim=-1)
    trans = log_a[:, None].expand(m, b, s, s).reshape(m * b, s, s)
    scores, paths = viterbi_banded_batch(
        log_b.reshape(m * b, t, s), trans, lengths.reshape(m * b))
    scores = scores.reshape(m, b)
    paths = paths.reshape(m, b, t)

    mask = torch.arange(t, device=batch.device) < lengths[..., None]  # (M, B, T)
    oh = _one_hot(paths, s) * mask[..., None]  # (M, B, T, S)
    counts = oh.sum(dim=(1, 2))  # (M, S)
    sums = torch.einsum("mbts,mbtd->msd", oh, batch)
    new_means = sums / torch.clamp(counts, min=1.0)[..., None]

    # Two-pass covariance (centered like np.cov), ddof=1 (:343).
    centered = batch[:, None] - new_means[:, :, None, None, :]  # (M, S, B, T, D)
    w = oh.permute(0, 3, 1, 2)[..., None]  # (M, S, B, T, 1)
    flat = centered.reshape(m, s, b * t, d)
    m2 = (flat * w.reshape(m, s, b * t, 1)).transpose(-1, -2) @ flat
    denom = torch.clamp(counts - 1.0, min=1.0)
    eye = torch.eye(d, dtype=torch.float32, device=batch.device)
    new_covs = m2 / denom[..., None, None] + cov_reg * eye

    # Transition counts over consecutive path pairs, t in [1, len)
    # (reference signal.py:81-91 iterates the full Viterbi path).
    pair_mask = torch.arange(t - 1, device=batch.device) < (lengths[..., None] - 1)
    from_oh = _one_hot(paths[..., :-1], s) * pair_mask[..., None]
    to_oh = _one_hot(paths[..., 1:], s)
    trans_counts = torch.einsum("mbts,mbtu->msu", from_oh, to_oh)
    row_sums = trans_counts.sum(dim=-1, keepdim=True)
    probs = trans_counts / torch.clamp(row_sums, min=1.0)
    # log(0) -> -inf without NaN; rows with no observed transitions stay -inf
    # (the reference would emit NaN there, signal.py:90 — divergence documented).
    new_log_a = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-38)),
                            torch.full_like(probs, float("-inf")))

    total_score = torch.where(lengths > 0, scores, torch.zeros_like(scores)).sum(-1)
    return new_means, new_covs, new_log_a, counts, total_score


def kmeans_step(means, covs, log_a, batch, lengths, num_states: int, cov_reg: float):
    """One E+M iteration on a padded (B, T, D) batch.

    Returns (new_means, new_covs, new_trans_log, counts, total_score). The
    caller decides convergence/failure from `counts` and the means delta.
    """
    out = kmeans_step_batched(means[None], covs[None], log_a[None], batch[None],
                              lengths[None], num_states, cov_reg)
    return tuple(x[0] for x in out)


@dataclass
class TrainResult:
    model: WordHMM
    iterations: int
    converged: bool
    final_score: float


def _tensor(x, dev, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def train_word_hmm(
    label: str,
    features: Sequence[np.ndarray],
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    mesh=None,
    device=None,
) -> TrainResult:
    """Train one word model from its utterances' (T_i, D) features, on
    ``device`` (reference HiddenMarkovModelTrainable.from_data,
    hidden_markov_model.py:233-281).

    With ``mesh`` (parallel/data_parallel.make_mesh; every rank calls this
    with the same features) the utterances shard over the ranks, padded to a
    multiple of the mesh size with length-0 rows, and each iteration's
    statistics are summed over them (dp_kmeans_step, whose covariance
    recentres moments taken around the previous means, where the
    single-device step keeps np.cov's two-pass form). The final score is
    then nan, as in the JAX package."""
    from ..parallel.data_parallel import dp_kmeans_step, mesh_size, site_device

    dev = site_device(mesh, device) if mesh is not None else resolve_device(device)
    means, covs, log_a = init_parameters(np.asarray(features[0]), cfg)
    padded = pad_batch([np.asarray(f, np.float32) for f in features],
                       cfg.length_multiple)
    data, lens = padded.data, padded.lengths
    if mesh is not None and len(lens) % mesh_size(mesh):
        pad_n = mesh_size(mesh) - len(lens) % mesh_size(mesh)
        data = np.concatenate([data, np.zeros((pad_n,) + data.shape[1:], np.float32)])
        lens = np.concatenate([lens, np.zeros(pad_n, np.int32)])
    batch = _tensor(data, dev)
    lengths = _tensor(lens, dev, torch.int32)

    converged = False
    it = 0
    score = float("-inf")
    for it in range(1, cfg.max_iterations + 1):
        params = (_tensor(means, dev), _tensor(covs, dev), _tensor(log_a, dev))
        if mesh is not None:
            new_means, new_covs, new_log_a, counts = dp_kmeans_step(
                *params, batch, lengths, mesh, cfg.num_states, cfg.cov_reg)
            score = float("nan")
        else:
            new_means, new_covs, new_log_a, counts, score = kmeans_step(
                *params, batch, lengths, cfg.num_states, cfg.cov_reg)
        counts_np = counts.cpu().numpy()
        if np.any(counts_np == 0):
            raise HMMTrainMeanFail(
                f"model {label!r}: states {np.where(counts_np == 0)[0].tolist()} "
                "received no frames"
            )
        new_means_np = new_means.cpu().numpy()
        if np.allclose(new_means_np, means, rtol=cfg.rtol, atol=cfg.atol):
            converged = True
            logger.info("model %s converged after %d iterations", label, it)
            break
        means, covs, log_a = (new_means_np, new_covs.cpu().numpy(),
                              new_log_a.cpu().numpy())

    model = WordHMM(label=label, means=means, covariances=covs, log_a=log_a)
    return TrainResult(model=model, iterations=it, converged=converged,
                       final_score=float(score))


def train_digit_models(
    features_by_label: dict,
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    batched: bool = True,
    device=None,
) -> dict:
    """Train one model per label (reference scripts/project3_train.py:24-30):
    all labels at once (train_digit_models_batched) unless ``batched`` is
    False or there is one label."""
    if batched and len(features_by_label) > 1:
        return train_digit_models_batched(features_by_label, cfg, device=device)
    models = {}
    for label, feats in features_by_label.items():
        result = train_word_hmm(label, feats, cfg, device=device)
        models[label] = result.model
        logger.info(
            "trained %s: %d iters, converged=%s", label, result.iterations,
            result.converged,
        )
    return models


def train_digit_models_batched(
    features_by_label: dict,
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    device=None,
) -> dict:
    """All labels trained simultaneously through the model axis of
    kmeans_step_batched.

    Per-label utterance counts are padded with zero-length dummies (length 0
    => every step is a no-op and the statistics masks exclude them).
    Per-model convergence freezes that model's parameters (matching the
    reference's per-model convergence exception) while the rest continue.
    """
    dev = resolve_device(device)
    labels = list(features_by_label)
    m = len(labels)
    feats = {l: [np.asarray(f) for f in features_by_label[l]] for l in labels}
    d = feats[labels[0]][0].shape[1]
    s = cfg.num_states

    b_max = max(len(v) for v in feats.values())
    t_max = max(f.shape[0] for v in feats.values() for f in v)
    t_pad = round_up(t_max, cfg.length_multiple)
    batch = np.zeros((m, b_max, t_pad, d), np.float32)
    lengths = np.zeros((m, b_max), np.int32)
    means = np.zeros((m, s, d), np.float32)
    covs = np.zeros((m, s, d, d), np.float32)
    log_a = np.zeros((m, s, s), np.float32)
    for i, label in enumerate(labels):
        for j, f in enumerate(feats[label]):
            batch[i, j, : f.shape[0]] = f
            lengths[i, j] = f.shape[0]
        means[i], covs[i], log_a[i] = init_parameters(feats[label][0], cfg)

    batch_t = _tensor(batch, dev)
    lengths_t = _tensor(lengths, dev, torch.int32)
    converged = np.zeros(m, bool)
    iterations = np.zeros(m, np.int32)
    for it in range(1, cfg.max_iterations + 1):
        new_means, new_covs, new_log_a, counts, _scores = kmeans_step_batched(
            _tensor(means, dev), _tensor(covs, dev), _tensor(log_a, dev),
            batch_t, lengths_t, cfg.num_states, cfg.cov_reg,
        )
        counts_np = counts.cpu().numpy()
        empty = (counts_np == 0) & ~converged[:, None]
        if np.any(empty):
            bad = [labels[i] for i in np.unique(np.argwhere(empty)[:, 0])]
            raise HMMTrainMeanFail(f"models with empty states: {bad}")
        new_means_np = new_means.cpu().numpy()
        new_covs_np = new_covs.cpu().numpy()
        new_log_a_np = new_log_a.cpu().numpy()
        for i in range(m):
            if converged[i]:
                continue
            if np.allclose(new_means_np[i], means[i], rtol=cfg.rtol, atol=cfg.atol):
                converged[i] = True
                iterations[i] = it
                continue
            means[i] = new_means_np[i]
            covs[i] = new_covs_np[i]
            log_a[i] = new_log_a_np[i]
        if converged.all():
            break

    models = {}
    for i, label in enumerate(labels):
        models[label] = WordHMM(
            label=label, means=means[i].copy(), covariances=covs[i].copy(),
            log_a=log_a[i].copy(),
        )
        logger.info(
            "trained %s (batched): converged=%s after %s iters",
            label, bool(converged[i]), int(iterations[i]) or "max",
        )
    return models
