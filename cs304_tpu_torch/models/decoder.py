"""Continuous-speech decoder over the flattened composite state space.

Word models are stacked into one composite; a batch is decoded by emissions
(whitening or quadratic form) -> composite Viterbi -> word compaction on the
device, and only (B, max_words) word ids and counts come back to the host.

Backends: "scanfree" runs the CUDA trellis pair (ops/cuda/trellis_scanfree.py)
and "fast" the plain PyTorch banded trellis (ops/viterbi.py); "pallas" runs
the dense (S, S) trellis kernel with K2's backtrace
(ops/cuda/trellis_dense.py) and "scan" its plain version
(ops/viterbi.viterbi_composite_batch); "auto" picks "scanfree" on a CUDA
device and "fast" on the CPU. The dense backends break an exact tie between
an entry's self-loop and a higher exit toward the self-loop; the banded ones
toward the exit. With emissions="quad" the emission kernel of the
``emission_precision`` tier (ops/cuda/emission.py: "highest" float32,
"high" three bf16 tensor-core passes, "default" one) writes log_b padded to
128 state columns, which every trellis reads in place. The device is the
card unless the caller passes device="cpu"; on the CPU every kernel wrapper
runs its plain version.

K-mixture GMM models (GMMWordHMM), alone or mixed with single Gaussians
(lifted to one-mixture rows, zero-weight padding), decode over the same
composite: "whiten" scores the S*K Gaussians and takes the logsumexp of
component + log weight over K; "quad" computes the S*K component densities
with the tier's emission kernel on a cached folded operand (the first S*K
columns of its padded layout) and combines them the same way, outside any
kernel, as the JAX package does. predict_signal_batch always scores GMMs
with the whitening layout, whatever ``emissions`` says, as the JAX decoder
does.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..data.batching import pad_batch
from ..device import resolve_device
from ..ops.cuda.emission import (
    LANES,
    fold_quad_params,
    pack_quad_params,
    split_hi_lo,
    tier_emission,
)
from ..ops.cuda.trellis_dense import dense_decode_pallas
from ..ops.cuda.trellis_scanfree import MAX_STATES, scanfree_decode
from ..ops.gaussian import (
    gaussian_log_pdf,
    gmm_combine,
    gmm_log_pdf,
    make_gaussian_params,
    make_gmm_params,
)
from ..ops.viterbi import (
    composite_transition_matrix,
    dense_decode,
    pack_coefs,
    viterbi_composite_batch_fast,
)
from ..ops.words import ids_to_strings, words_from_paths
from .hmm import DEFAULT_WORD_PENALTY, WordHMM, stack_word_models

# Word buffer of the on-device compaction; a longer transcript falls back to
# the host walk of the full path.
MAX_WORDS = 64


def _lift_to_gmm(models):
    """Mixed WordHMM / GMMWordHMM list -> (single-Gaussian boundary views,
    (means (S, K, D), covs (S, K, D, D), weights (S, K)) stacked over the
    composite's states and padded to a common K by pad_mixture_params)."""
    from .gmm_hmm import GMMWordHMM, pad_mixture_params

    k_max = max(m.num_mixtures if isinstance(m, GMMWordHMM) else 1 for m in models)
    views, means_l, covs_l, weights_l = [], [], [], []
    for m in models:
        mm, cc, ww = pad_mixture_params(m, k_max)
        if isinstance(m, GMMWordHMM):
            views.append(WordHMM(label=m.label, means=m.means[:, 0],
                                 covariances=m.covariances[:, 0], log_a=m.log_a))
        else:
            views.append(m)
        means_l.append(mm)
        covs_l.append(cc)
        weights_l.append(ww)
    return views, (np.concatenate(means_l), np.concatenate(covs_l),
                   np.concatenate(weights_l))


class ContinuousDecoder:
    """Batched continuous decoding with optional silence handling, over
    single-Gaussian word models, GMM word models or a mix of both."""

    def __init__(
        self,
        models,
        penalty: float = DEFAULT_WORD_PENALTY,
        sort_labels: bool = True,
        backend: str = "auto",
        bigram=None,
        lm_weight: float = 1.0,
        beam: float | None = None,
        emissions: str = "whiten",
        emission_precision: str = "highest",
        device=None,
    ) -> None:
        if isinstance(models, dict):
            models = list(models.values())
        if sort_labels:
            models = sorted(models, key=lambda m: m.label)
        if backend not in ("auto", "scan", "fast", "pallas", "scanfree"):
            raise ValueError(f"unknown backend {backend!r}")
        if emissions not in ("whiten", "quad"):
            raise ValueError(f"unknown emissions layout {emissions!r}")
        if emission_precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown emission precision {emission_precision!r}")
        if emission_precision != "highest" and emissions != "quad":
            raise ValueError(
                "emission_precision tiers below 'highest' require "
                "emissions='quad' (the whitening layout stays f32-exact "
                "by contract)"
            )
        if bigram is not None:
            raise NotImplementedError(
                "bigram LM decoding is not ported yet (ROADMAP Queue 1, slice 4)"
            )
        if beam is not None:
            raise NotImplementedError(
                "beam pruning is not ported yet (ROADMAP Queue 1, slice 4)"
            )
        self.device = resolve_device(device)
        if backend == "auto":
            backend = "scanfree" if self.device.type == "cuda" else "fast"
        self.backend = backend
        self.emissions = emissions
        self.emission_precision = emission_precision
        # The bigram LM's weight: stored, and with no bigram it changes
        # nothing (as in the JAX decoder).
        self._lm_weight = lm_weight
        self._gmm = None  # (means, covs, weights) stacked over states
        if any(getattr(m, "weights", None) is not None for m in models):
            views, self._gmm = _lift_to_gmm(models)
            self.composite = stack_word_models(views, penalty)
        else:
            self.composite = stack_word_models(models, penalty)
        if backend in ("scanfree", "pallas") and self.composite.num_states > MAX_STATES:
            raise ValueError(
                f"{self.composite.num_states} states exceed the {backend} "
                f"trellis limit of {MAX_STATES}; use backend='fast'"
            )
        self._prepare()

    def _prepare(self) -> None:
        """Move the model to the device once: emission parameters (and
        the tier's folded kernel operand on the card, or their bf16 split
        below "highest" on the CPU), trellis coefficients, the dense
        transition matrix of the dense backends, and word boundaries. A GMM
        decoder's quad operand covers its S*K Gaussians, and it keeps the
        whitening parameters too (predict_signal_batch's layout)."""
        c, dev = self.composite, self.device
        means, covs = c.means, c.covariances
        n_gauss = c.num_states
        if self._gmm is not None:
            g_means, g_covs, g_weights = self._gmm
            s, k, d = g_means.shape
            means, covs = g_means.reshape(s * k, d), g_covs.reshape(s * k, d, d)
            n_gauss = s * k
            self._gmm_whiten = make_gmm_params(g_means, g_covs, g_weights, device=dev)
        self._n_gauss = n_gauss
        self._s_pad = -(-n_gauss // LANES) * LANES
        if self.emissions == "quad":
            self._quad = pack_quad_params(means, covs, self._s_pad, device=dev)
            on_card = dev.type == "cuda"
            # The card runs the tier's folded operand, the CPU the plain
            # version on the unfolded (split) parameters.
            self._folded = (fold_quad_params(*self._quad, self.emission_precision,
                                             n_gauss) if on_card else None)
            self._nhp_split = (None if self.emission_precision == "highest" or on_card
                               else split_hi_lo(self._quad[0]))
        elif self._gmm is None:
            self._whiten = make_gaussian_params(means, covs, device=dev)
        self._coefs = pack_coefs(c.log_a, c.lower_of_state, c.is_entry,
                                 c.is_exit, device=dev)
        self._trans = self._dense_trans()
        self._lowers = torch.as_tensor(c.lowers, dtype=torch.int32, device=dev)
        self._uppers = torch.as_tensor(c.uppers, dtype=torch.int32, device=dev)

    @property
    def penalty(self) -> float:
        return self.composite.penalty

    @penalty.setter
    def penalty(self, value: float) -> None:
        self.composite.penalty = value
        self._trans = self._dense_trans()

    def _dense_trans(self):
        """The (S, S) transition matrix of the dense backends, which carries
        the penalty; None for the banded ones."""
        if self.backend not in ("scan", "pallas"):
            return None
        c = self.composite
        return composite_transition_matrix(c.log_a, c.lower_of_state, c.is_entry,
                                           c.is_exit, c.penalty, device=self.device)

    # -- device path ---------------------------------------------------------
    def _log_b(self, batch: torch.Tensor, whiten: bool = False) -> torch.Tensor:
        """(B, T, D) -> (B, T, S) or, for single-Gaussian "quad", (B, T,
        s_pad) emissions. whiten=True scores a GMM decoder's models with the
        whitening layout whatever ``emissions`` says."""
        if self._gmm is not None and (whiten or self.emissions == "whiten"):
            return gmm_log_pdf(self._gmm_whiten, batch)
        if self.emissions == "quad":
            b, t, d = batch.shape
            out = tier_emission(batch.reshape(b * t, d), *self._quad,
                                num_states=self._n_gauss,
                                s_pad=self._s_pad,
                                precision=self.emission_precision,
                                nhp_split=self._nhp_split,
                                folded=self._folded)
            if self._gmm is not None:
                comp = out[:, : self._n_gauss]
                return gmm_combine(comp, self._gmm_whiten.log_weights).reshape(b, t, -1)
            return out.reshape(b, t, self._s_pad)
        return gaussian_log_pdf(self._whiten, batch)

    def decode(self, batch: torch.Tensor, lengths: torch.Tensor,
               whiten: bool = False):
        """(B, T, D) float32 features + (B,) lengths on the decoder's device
        -> (scores (B,), paths (B, T) int32). whiten: see _log_b."""
        log_b = self._log_b(batch, whiten).contiguous()
        c = self.composite
        if self.backend == "scanfree":
            return scanfree_decode(log_b, self._coefs, c.penalty, lengths)
        if self.backend == "pallas":
            return dense_decode_pallas(log_b, self._trans, self._coefs, lengths)
        if self.backend == "scan":
            return dense_decode(log_b, self._trans, self._coefs, lengths)
        return viterbi_composite_batch_fast(
            log_b, c.log_a, c.lower_of_state, c.is_entry, c.is_exit,
            c.penalty, lengths,
        )

    def _silence_word(self, skip_silence: bool) -> int:
        labels = self.composite.labels
        return labels.index("S") if (skip_silence and "S" in labels) else -1

    def _words(self, paths, lengths, skip_silence: bool):
        return words_from_paths(
            paths, lengths, None, self._lowers, self._uppers,
            self._silence_word(skip_silence), max_words=MAX_WORDS,
        )

    def decode_signals(self, signals: torch.Tensor, n_samples: torch.Tensor,
                       skip_silence: bool = True, mcfg=None):
        """Raw (B, L) audio + (B,) sample counts on the decoder's device ->
        (scores (B,), word ids (B, MAX_WORDS), counts (B,)): MFCC, emissions,
        trellis and word compaction, all on the device."""
        from ..ops.mfcc import MFCCConfig, mfcc_features_batch

        feats, n_frames = mfcc_features_batch(
            signals, n_samples, mcfg if mcfg is not None else MFCCConfig()
        )
        # GMMs go through the whitening layout here, as in the JAX decoder.
        scores, paths = self.decode(feats, n_frames, whiten=True)
        ids, counts = self._words(paths, n_frames, skip_silence)
        return scores, ids, counts

    # -- host entry points ---------------------------------------------------
    def _to_device(self, padded):
        return (torch.as_tensor(padded.data, device=self.device),
                torch.as_tensor(padded.lengths, device=self.device))

    def predict(self, features, skip_silence: bool = True) -> str:
        return self.predict_batch([np.asarray(features)], skip_silence)[0]

    def _buckets(self, features: Sequence[np.ndarray]) -> List[List[int]]:
        """Utterance indices grouped by padded length (128-frame multiples)."""
        buckets: Dict[int, List[int]] = {}
        for i, f in enumerate(features):
            key = -(-max(np.asarray(f).shape[0], 1) // 128) * 128
            buckets.setdefault(key, []).append(i)
        return list(buckets.values())

    def predict_batch(
        self, features: Sequence[np.ndarray], skip_silence: bool = True
    ) -> List[str]:
        """Decode a ragged list of (T_i, D) features to label strings, one
        device batch per 128-frame length bucket. A transcript longer than
        the word buffer is read from the full path on the host instead."""
        out: List[str] = [""] * len(features)
        c = self.composite
        for idx in self._buckets(features):
            padded = pad_batch([np.asarray(features[i]) for i in idx], 128)
            batch, lengths = self._to_device(padded)
            _scores, paths = self.decode(batch, lengths)
            ids, counts = self._words(paths, lengths, skip_silence)
            try:
                strings = ids_to_strings(ids.cpu().numpy(), counts.cpu().numpy(),
                                         c.labels)
            except ValueError:
                paths_np = paths.cpu().numpy()
                strings = [
                    "".join(c.path_to_labels(paths_np[row, :n], skip_silence))
                    for row, n in enumerate(padded.lengths)
                ]
            for i, s in zip(idx, strings):
                out[i] = s
        return out

    def predict_signal_batch(
        self, signals: Sequence[np.ndarray], skip_silence: bool = True,
        mcfg=None, length_multiple: int = 16000,
    ) -> List[str]:
        """Decode raw audio end to end on the device, one batch per
        ``length_multiple``-sample bucket, the batch padded to a power of two
        (at least 4) with 1-frame dummy rows. A transcript longer than the
        word buffer falls back to host MFCC + predict_batch."""
        from ..ops.mfcc import MFCCConfig, mfcc_batch

        if mcfg is None:
            mcfg = MFCCConfig()
        out: List[str] = [""] * len(signals)
        buckets: Dict[int, List[int]] = {}
        for i, s in enumerate(signals):
            key = -(-max(len(s), 1) // length_multiple) * length_multiple
            buckets.setdefault(key, []).append(i)
        for key, idx in buckets.items():
            b_pad = max(4, 1 << (len(idx) - 1).bit_length())
            padded = np.zeros((b_pad, key), np.float32)
            n_samples = np.full(b_pad, 160, np.int32)
            for row, i in enumerate(idx):
                sig = np.asarray(signals[i], np.float32).reshape(-1)
                padded[row, : len(sig)] = sig
                n_samples[row] = len(sig)
            _scores, ids, counts = self.decode_signals(
                torch.as_tensor(padded, device=self.device),
                torch.as_tensor(n_samples, device=self.device),
                skip_silence, mcfg,
            )
            try:
                texts = ids_to_strings(ids.cpu().numpy(), counts.cpu().numpy(),
                                       self.composite.labels)[: len(idx)]
            except ValueError:
                texts = self.predict_batch(
                    mfcc_batch([signals[i] for i in idx], cfg=mcfg,
                               device=self.device),
                    skip_silence,
                )
            for row, i in enumerate(idx):
                out[i] = texts[row]
        return out

    def viterbi_batch(self, features: Sequence[np.ndarray], bucket: bool = True):
        """Returns (scores (B,), paths (B, T) np.int32, lengths (B,)).
        bucket=True decodes each 128-frame length bucket as its own device
        batch, paths padded to the longest bucket; bucket=False (or a single
        utterance, or a single bucket) decodes the whole list as one
        128-padded batch."""
        padded_all = pad_batch([np.asarray(f) for f in features], 128)
        b = len(features)
        scores = np.zeros(b, np.float32)
        paths = np.zeros((b, padded_all.data.shape[1]), np.int32)
        groups = self._buckets(features) if bucket else [list(range(b))]
        for idx in groups:
            padded = pad_batch([np.asarray(features[i]) for i in idx], 128)
            s_k, p_k = self.decode(*self._to_device(padded))
            scores[idx] = s_k.cpu().numpy()
            paths[idx, : p_k.shape[1]] = p_k.cpu().numpy()
        return scores, paths, padded_all.lengths
