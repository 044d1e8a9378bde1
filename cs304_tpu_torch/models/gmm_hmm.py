"""K-mixture GMM-HMM word models with segmental k-means and Baum-Welch
training.

A port of cs304_tpu/models/gmm_hmm.py (capability parity with the
reference's deprecated GMM-HMM, deprecated/gaussian_mixture_model.py:17-240):
per-state mixture weights, per-mixture full-covariance Gaussians, Viterbi
training with per-frame best-mixture assignment, Baum-Welch refinement and
forward-likelihood scoring. K = 1 reproduces the single-Gaussian path.
Alignments come from the banded single-word Viterbi (ops/viterbi.py) and the
posteriors from ops/forward_backward.py; every statistic is a one-hot or
posterior-weighted matmul, float32 with TF32 off. Models hold NumPy arrays,
as WordHMM does; tensors are made on the device the caller picks.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..data.batching import pad_batch
from ..device import fp32_exact, resolve_device
from ..ops.forward_backward import forward_backward, forward_log_likelihood
from ..ops.gaussian import gmm_log_pdf, make_gmm_params
from ..ops.logmath import logsumexp
from ..ops.viterbi import viterbi_banded, viterbi_banded_batch
from .hmm import WordHMM
from .train_kmeans import HMMTrainMeanFail, SegmentalKMeansConfig, init_parameters

logger = logging.getLogger(__name__)


def pad_mixture_params(model, k_max: int):
    """(means (S, K_max, D), covs, weights) of a WordHMM or GMMWordHMM,
    padded to k_max mixtures: the lifting convention of the decoder's
    composite stack. Padding mixtures get zero weight (log 0 drops out of
    gmm_log_pdf's logsumexp) and identity covariances (well conditioned,
    never weighed in)."""
    s_states = model.num_states
    d = int(model.means.shape[-1])
    mm = np.zeros((s_states, k_max, d), np.float32)
    cc = np.tile(np.eye(d, dtype=np.float32), (s_states, k_max, 1, 1))
    ww = np.zeros((s_states, k_max), np.float32)
    if isinstance(model, GMMWordHMM):
        k = model.num_mixtures
        mm[:, :k] = model.means
        cc[:, :k] = model.covariances
        ww[:, :k] = model.weights
    else:
        mm[:, 0] = model.means
        cc[:, 0] = model.covariances
        ww[:, 0] = 1.0
    return mm, cc, ww


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


@dataclass
class GMMWordHMM:
    """A left-to-right word model with K-mixture GMM emissions."""

    label: str
    means: np.ndarray  # (S, K, D)
    covariances: np.ndarray  # (S, K, D, D)
    weights: np.ndarray  # (S, K)
    log_a: np.ndarray  # (S, S)

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    @property
    def num_mixtures(self) -> int:
        return self.means.shape[1]

    def emission_params(self, device=None):
        return make_gmm_params(self.means, self.covariances, self.weights,
                               device=resolve_device(device))

    def log_likelihoods(self, features, device=None) -> torch.Tensor:
        params = self.emission_params(device)
        return gmm_log_pdf(params, _f32(features, params.means.device))

    def predict(self, features, length=None, device=None):
        """Viterbi score + path (the GMM analogue of a word model's predict)."""
        log_b = self.log_likelihoods(features, device)
        return viterbi_banded(log_b, _f32(self.log_a, log_b.device), length)

    def forward_score(self, features, length=None, device=None) -> float:
        """Forward log-likelihood (deprecated/gaussian_mixture_model.py:223-239)."""
        log_b = self.log_likelihoods(features, device)
        s = self.num_states
        log_init = torch.full((s,), float("-inf"), device=log_b.device)
        log_init[0] = 0.0
        return float(forward_log_likelihood(
            log_b, _f32(self.log_a, log_b.device), log_init, length))


def _one_hot(idx, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx.to(torch.int64), n).to(torch.float32)


def _gmm_kmeans_step(means, covs, weights, log_a, batch, lengths,
                     num_states: int, num_mixtures: int, cov_reg: float):
    """One segmental-k-means iteration with per-frame best-mixture assignment
    (deprecated/gaussian_mixture_model.py:86-150, as matmuls)."""
    fp32_exact()
    s, k = num_states, num_mixtures
    b, t, d = batch.shape
    dev = batch.device
    params = make_gmm_params(means, covs, weights, device=dev)
    log_b, comp = gmm_log_pdf(params, batch, return_components=True)  # (B,T,S), (B,T,S,K)
    _scores, paths = viterbi_banded_batch(log_b, log_a, lengths)
    paths = paths.to(torch.int64)

    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).to(torch.float32)
    oh_state = _one_hot(paths, s) * mask[..., None]
    # Best mixture of the *assigned* state per frame (first max).
    comp_of_state = comp.gather(2, paths[..., None, None].expand(b, t, 1, k))[:, :, 0, :]
    oh_mix = _one_hot(torch.argmax(comp_of_state, dim=-1), k)
    w = oh_state[..., :, None] * oh_mix[..., None, :]  # (B, T, S, K)

    counts = torch.sum(w, dim=(0, 1))  # (S, K)
    sums = torch.einsum("btsk,btd->skd", w, batch)
    new_means = sums / torch.clamp(counts, min=1.0)[..., None]

    # Centred second moments, one slot per (state, mixture) pair.
    w_flat = w.reshape(b * t, s * k)
    centered = batch.reshape(b * t, 1, d) - new_means.reshape(1, s * k, d)
    m2 = torch.einsum("nf,nfd,nfe->fde", w_flat, centered, centered).reshape(s, k, d, d)
    denom = torch.clamp(counts - 1.0, min=1.0)
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    new_covs = m2 / denom[..., None, None] + cov_reg * eye

    state_counts = torch.sum(counts, dim=1, keepdim=True)
    new_weights = torch.where(state_counts > 0,
                              counts / torch.clamp(state_counts, min=1.0), weights)

    pair_mask = (torch.arange(t - 1, device=dev)[None, :] < (lengths[:, None] - 1))
    from_oh = _one_hot(paths[:, :-1], s) * pair_mask[..., None].to(torch.float32)
    to_oh = _one_hot(paths[:, 1:], s)
    trans = torch.einsum("bts,btu->su", from_oh, to_oh)
    probs = trans / torch.clamp(trans.sum(dim=1, keepdim=True), min=1.0)
    new_log_a = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-38)),
                            torch.full_like(probs, float("-inf")))
    return new_means, new_covs, new_weights, new_log_a, counts, counts.sum(dim=1)


def train_gmm_hmm(
    label: str,
    features: Sequence[np.ndarray],
    num_mixtures: int = 4,
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    seed: int = 0,
    device=None,
) -> GMMWordHMM:
    """Segmental k-means GMM-HMM training (the reference's deprecated GMM
    capability, K = NUM_MIXTURES = 4 there,
    deprecated/gaussian_mixture_model.py:15), on ``device``."""
    dev = resolve_device(device)
    s, k = cfg.num_states, num_mixtures
    base_means, base_covs, log_a = init_parameters(np.asarray(features[0]), cfg)
    d = base_means.shape[1]
    rng = np.random.default_rng(seed)
    # Jittered copies of the k-means init, so that mixtures can differentiate.
    means = base_means[:, None, :] + rng.normal(0, 0.05, size=(s, k, d)).astype(np.float32)
    covs = np.tile(base_covs[:, None], (1, k, 1, 1))
    weights = np.full((s, k), 1.0 / k, np.float32)

    padded = pad_batch(list(features), cfg.length_multiple)
    batch = _f32(padded.data, dev)
    lengths = torch.as_tensor(padded.lengths, device=dev)

    for it in range(1, cfg.max_iterations + 1):
        new_means, new_covs, new_weights, new_log_a, counts, state_totals = (
            _gmm_kmeans_step(_f32(means, dev), _f32(covs, dev), _f32(weights, dev),
                             _f32(log_a, dev), batch, lengths, s, k, cfg.cov_reg))
        if bool(torch.any(state_totals == 0)):
            raise HMMTrainMeanFail(f"GMM model {label!r}: empty state")
        # Empty mixtures keep their previous parameters.
        empty_mix = counts.cpu().numpy() == 0
        new_means_np = np.where(empty_mix[..., None], means, new_means.cpu().numpy())
        new_covs_np = np.where(empty_mix[..., None, None], covs, new_covs.cpu().numpy())
        if np.allclose(new_means_np, means, rtol=cfg.rtol, atol=cfg.atol):
            logger.info("GMM model %s converged after %d iterations", label, it)
            break
        means = new_means_np
        covs = new_covs_np
        weights = new_weights.cpu().numpy()
        log_a = new_log_a.cpu().numpy()

    return GMMWordHMM(label=label, means=np.asarray(means, np.float32),
                      covariances=np.asarray(covs, np.float32),
                      weights=np.asarray(weights, np.float32),
                      log_a=np.asarray(log_a, np.float32))


def _bw_stats(means, covs, weights, log_a, batch, lengths, cov_reg: float):
    """Baum-Welch E-step statistics and M-step of a padded batch of one
    word's clips -> (new_means, new_covs, new_weights, new_log_a, counts,
    total log-likelihood)."""
    fp32_exact()
    s, k, d = means.shape
    dev = batch.device
    params = make_gmm_params(means, covs, weights, device=dev)
    log_init = torch.full((s,), float("-inf"), device=dev)
    log_init[0] = 0.0

    log_b, comp = gmm_log_pdf(params, batch, return_components=True)
    gamma, xi, loglik = forward_backward(log_b, log_a, log_init, lengths)
    # Mixture responsibilities within each state.
    log_resp = comp - logsumexp(comp, axis=-1, keepdims=True)
    gamma_k = gamma[..., None] * torch.exp(log_resp)  # (B, T, S, K)
    counts = torch.sum(gamma_k, dim=(0, 1))  # (S, K)
    # Moments centred on the previous means (the raw one-pass form cancels
    # catastrophically in low precision).
    b, t = batch.shape[:2]
    g_flat = gamma_k.reshape(b * t, s * k)
    centered = batch.reshape(b * t, 1, d) - means.reshape(1, s * k, d)
    c_sums = torch.einsum("nf,nfd->fd", g_flat, centered).reshape(s, k, d)
    c_m2 = torch.einsum("nf,nfd,nfe->fde", g_flat, centered, centered).reshape(s, k, d, d)
    xi = torch.sum(xi, dim=0)
    total_ll = torch.sum(loglik)

    safe = torch.clamp(counts, min=1e-6)
    delta = c_sums / safe[..., None]  # new mean - previous mean
    new_means = means + delta
    # Recentre: sum g (x - mu_new)(x - mu_new)^T = c_m2 - counts delta delta^T.
    m2_new = c_m2 - counts[..., None, None] * (delta[..., :, None] * delta[..., None, :])
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    new_covs = m2_new / safe[..., None, None] + cov_reg * eye
    new_weights = counts / torch.clamp(counts.sum(dim=1, keepdim=True), min=1e-6)
    probs = xi / torch.clamp(xi.sum(dim=1, keepdim=True), min=1e-6)
    new_log_a = torch.where(probs > 1e-30, torch.log(torch.clamp(probs, min=1e-38)),
                            torch.full_like(probs, float("-inf")))
    return new_means, new_covs, new_weights, new_log_a, counts, total_ll


def train_word_hmm_baum_welch(
    label: str,
    features: Sequence[np.ndarray],
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    init=None,
    tol: float = 1e-3,
    device=None,
) -> WordHMM:
    """Soft-EM (Baum-Welch) single-Gaussian word training: the K = 1 GMM path
    collapsed back to a WordHMM."""
    if init is not None and not isinstance(init, GMMWordHMM):
        init = GMMWordHMM(
            label=init.label,
            means=init.means[:, None],
            covariances=init.covariances[:, None],
            weights=np.ones((init.num_states, 1), np.float32),
            log_a=init.log_a,
        )
    gmm = train_gmm_hmm_baum_welch(label, features, num_mixtures=1, cfg=cfg,
                                   init=init, tol=tol, device=device)
    return WordHMM(label=label, means=gmm.means[:, 0].copy(),
                   covariances=gmm.covariances[:, 0].copy(), log_a=gmm.log_a.copy())


def train_gmm_hmm_baum_welch(
    label: str,
    features: Sequence[np.ndarray],
    num_mixtures: int = 1,
    cfg: SegmentalKMeansConfig = SegmentalKMeansConfig(),
    init: GMMWordHMM | None = None,
    tol: float = 1e-3,
    device=None,
) -> GMMWordHMM:
    """Soft-EM (Baum-Welch) refinement, stopping on a relative
    log-likelihood gain < tol. Seeded from segmental k-means unless ``init``
    is given."""
    dev = resolve_device(device)
    if init is None:
        init = train_gmm_hmm(label, features, num_mixtures, cfg, device=dev)
    means, covs, weights, log_a = (init.means.copy(), init.covariances.copy(),
                                   init.weights.copy(), init.log_a.copy())
    padded = pad_batch(list(features), cfg.length_multiple)
    batch = _f32(padded.data, dev)
    lengths = torch.as_tensor(padded.lengths, device=dev)

    last_ll = -np.inf
    for it in range(1, cfg.max_iterations + 1):
        new_means, new_covs, new_weights, new_log_a, counts, ll = _bw_stats(
            _f32(means, dev), _f32(covs, dev), _f32(weights, dev), _f32(log_a, dev),
            batch, lengths, cfg.cov_reg)
        ll = float(ll)
        empty = counts.cpu().numpy() < 1e-3
        means = np.where(empty[..., None], means, new_means.cpu().numpy())
        covs = np.where(empty[..., None, None], covs, new_covs.cpu().numpy())
        weights = new_weights.cpu().numpy()
        log_a = new_log_a.cpu().numpy()
        if np.isfinite(last_ll) and abs(ll - last_ll) < tol * abs(last_ll):
            logger.info("BW %s converged after %d iterations (ll=%.2f)", label, it, ll)
            break
        if np.isfinite(last_ll) and ll < last_ll - 1e-3 * abs(last_ll):
            logger.warning("BW %s log-likelihood decreased: %.3f -> %.3f",
                           label, last_ll, ll)
        last_ll = ll

    return GMMWordHMM(label=label, means=np.asarray(means, np.float32),
                      covariances=np.asarray(covs, np.float32),
                      weights=np.asarray(weights, np.float32),
                      log_a=np.asarray(log_a, np.float32))
