"""Continuous-speech decoder over the flattened composite state space.

Word models are stacked into one composite; a batch is decoded by emissions
(whitening or quadratic form) -> composite Viterbi -> word compaction on the
device, and only (B, max_words) word ids and counts come back to the host.

Backends: "scanfree" runs the CUDA trellis pair (ops/cuda/trellis_scanfree.py)
and "fast" the plain PyTorch trellis (ops/viterbi.py); "auto" picks
"scanfree" on a CUDA device and "fast" on the CPU. With emissions="quad" the
emission kernel (ops/cuda/emission.py) writes log_b padded to 128 state
columns, which the trellis reads in place. On a CPU device every kernel
wrapper runs its plain version.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..data.batching import pad_batch
from ..device import resolve_device
from ..ops.cuda.emission import LANES, emission, pack_quad_params
from ..ops.cuda.trellis_scanfree import MAX_STATES, scanfree_decode
from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import pack_coefs, viterbi_composite_batch_fast
from ..ops.words import ids_to_strings, words_from_paths
from .hmm import DEFAULT_WORD_PENALTY, stack_word_models

# Word buffer of the on-device compaction; a longer transcript falls back to
# the host walk of the full path.
MAX_WORDS = 64


class ContinuousDecoder:
    """Batched continuous decoding with optional silence handling
    (single-Gaussian word models)."""

    def __init__(
        self,
        models,
        penalty: float = DEFAULT_WORD_PENALTY,
        sort_labels: bool = True,
        backend: str = "auto",
        bigram=None,
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
        if backend in ("scan", "pallas"):
            where = ("Queue 2, K4" if backend == "pallas"
                     else "Queue 1, item 4: the dense viterbi_composite_batch")
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet (ROADMAP {where})"
            )
        if bigram is not None:
            raise NotImplementedError(
                "bigram LM decoding is not ported yet (ROADMAP Queue 1, slice 4)"
            )
        if beam is not None:
            raise NotImplementedError(
                "beam pruning is not ported yet (ROADMAP Queue 1, slice 4)"
            )
        if emission_precision != "highest":
            raise NotImplementedError(
                f"emission precision {emission_precision!r} is not ported yet "
                "(ROADMAP Queue 2: K1-high / the default-tier A/B)"
            )
        if any(getattr(m, "weights", None) is not None for m in models):
            raise NotImplementedError(
                "GMM word models are not ported yet (ROADMAP Queue 1, slice 3)"
            )
        self.device = resolve_device(device)
        if backend == "auto":
            backend = "scanfree" if self.device.type == "cuda" else "fast"
        self.backend = backend
        self.emissions = emissions
        self.emission_precision = emission_precision
        self.composite = stack_word_models(models, penalty)
        if backend == "scanfree" and self.composite.num_states > MAX_STATES:
            raise ValueError(
                f"{self.composite.num_states} states exceed the scan-free "
                f"trellis limit of {MAX_STATES}; use backend='fast'"
            )
        self._prepare()

    def _prepare(self) -> None:
        """Move the model to the device once: emission parameters, trellis
        coefficients and word boundaries."""
        c, dev = self.composite, self.device
        self._s_pad = -(-c.num_states // LANES) * LANES
        if self.emissions == "quad":
            self._quad = pack_quad_params(c.means, c.covariances, self._s_pad,
                                          device=dev)
        else:
            self._whiten = make_gaussian_params(c.means, c.covariances, device=dev)
        self._coefs = pack_coefs(c.log_a, c.lower_of_state, c.is_entry,
                                 c.is_exit, device=dev)
        self._lowers = torch.as_tensor(c.lowers, dtype=torch.int32, device=dev)
        self._uppers = torch.as_tensor(c.uppers, dtype=torch.int32, device=dev)

    @property
    def penalty(self) -> float:
        return self.composite.penalty

    @penalty.setter
    def penalty(self, value: float) -> None:
        self.composite.penalty = value

    # -- device path ---------------------------------------------------------
    def _log_b(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, T, S) or, for "quad", (B, T, s_pad) emissions."""
        if self.emissions == "quad":
            b, t, d = batch.shape
            out = emission(batch.reshape(b * t, d), *self._quad,
                           num_states=self.composite.num_states, s_pad=self._s_pad)
            return out.reshape(b, t, self._s_pad)
        return gaussian_log_pdf(self._whiten, batch)

    def decode(self, batch: torch.Tensor, lengths: torch.Tensor):
        """(B, T, D) float32 features + (B,) lengths on the decoder's device
        -> (scores (B,), paths (B, T) int32)."""
        log_b = self._log_b(batch)
        c = self.composite
        if self.backend == "scanfree":
            return scanfree_decode(log_b, self._coefs, c.penalty, lengths)
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
        scores, paths = self.decode(feats, n_frames)
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

    def viterbi_batch(self, features: Sequence[np.ndarray]):
        """Returns (scores (B,), paths (B, T) np.int32, lengths (B,)), paths
        padded to the longest bucket; each 128-frame length bucket is one
        device batch."""
        padded_all = pad_batch([np.asarray(f) for f in features], 128)
        b = len(features)
        scores = np.zeros(b, np.float32)
        paths = np.zeros((b, padded_all.data.shape[1]), np.int32)
        for idx in self._buckets(features):
            padded = pad_batch([np.asarray(features[i]) for i in idx], 128)
            s_k, p_k = self.decode(*self._to_device(padded))
            scores[idx] = s_k.cpu().numpy()
            paths[idx, : p_k.shape[1]] = p_k.cpu().numpy()
        return scores, paths, padded_all.lengths
