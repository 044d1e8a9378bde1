"""Chunked (online) composite Viterbi decoding of one stream.

Feed fixed-size feature chunks as they arrive, keep the (S,) alpha carry on
the device and the backpointer history on the host, and read a partial
hypothesis at any time. ``finalize()`` reproduces the offline decoder's
result exactly (standard backtrace; the chunk boundary is invisible to the
recursion).

A chunk is one K4 forward (ops/cuda/trellis_stream.py:k4_chunk, the same
dense step as the batched pool's), its plain version dense_forward on the
CPU; the JAX package's counterpart is cs304_tpu/ops/streaming.py
(_stream_chunk, a lax.scan). Streaming operates at the feature level: the
reference MFCC normalization is utterance-global, so parity features need
the whole utterance (ops/streaming_mfcc.py is the causal front end).
GMM models stream with their K-mixture densities (gmm_params, or
from_models on a GMM or mixed model list).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import resolve_device
from .viterbi import composite_transition_matrix, pack_coefs

class StreamingComposite:
    """Online continuous decoding over a CompositeHMM.

    >>> stream = StreamingComposite(composite, chunk_size=64)
    >>> for feats_chunk in source:          # (c, D) arrays, c <= chunk_size
    ...     stream.feed(feats_chunk)
    ...     print(stream.partial_labels())  # best hypothesis so far
    >>> score, path = stream.finalize()
    """

    def __init__(self, composite, chunk_size: int = 64,
                 gmm_params=None, device=None) -> None:
        """gmm_params: optional ops.gaussian.GMMParams over the composite's
        states, on ``device``: emissions become K-mixture log-densities (the
        composite itself carries only the single-Gaussian boundary view;
        from_models builds both). device: None means the card (raising
        without one); tests pass "cpu"."""
        from .gaussian import make_gaussian_params

        self.device = dev = resolve_device(device)
        self.composite = c = composite
        self.chunk_size = chunk_size
        self._trans = composite_transition_matrix(
            c.log_a, c.lower_of_state, c.is_entry, c.is_exit, c.penalty, device=dev)
        self._coefs = pack_coefs(c.log_a, c.lower_of_state, c.is_entry, c.is_exit,
                                 device=dev)
        self._gmm_params = gmm_params
        self._emission_params = (None if gmm_params is not None else
                                 make_gaussian_params(c.means, c.covariances, device=dev))
        self.reset()

    @classmethod
    def from_models(cls, models, penalty: float = -100.0,
                    chunk_size: int = 64, device=None) -> "StreamingComposite":
        """Streaming decoder from a model dict/list (sorted by label, as the
        decoder stacks them), GMM-aware: K-mixture models stream with their
        GMM densities (the decoder's lift, models/decoder.py:_lift_to_gmm)."""
        from ..models.decoder import _lift_to_gmm
        from ..models.hmm import stack_word_models
        from .gaussian import make_gmm_params

        if isinstance(models, dict):
            models = list(models.values())
        models = sorted(models, key=lambda m: m.label)
        if any(getattr(m, "weights", None) is not None for m in models):
            views, (means, covs, weights) = _lift_to_gmm(models)
            dev = resolve_device(device)
            return cls(stack_word_models(views, penalty), chunk_size,
                       gmm_params=make_gmm_params(means, covs, weights, device=dev),
                       device=dev)
        return cls(stack_word_models(models, penalty), chunk_size, device=device)

    def reset(self) -> None:
        self._alpha = None  # set on first feed
        self._bp_chunks: List[np.ndarray] = []
        self._t = 0

    def feed(self, features: np.ndarray) -> None:
        """Feed a (c, D) feature chunk, c <= chunk_size (longer chunks are
        split)."""
        from .cuda.trellis_stream import k4_chunk
        from .gaussian import gaussian_log_pdf, gmm_log_pdf

        features = np.asarray(features, np.float32)
        c = features.shape[0]
        if c == 0:
            return
        if c > self.chunk_size:
            for start in range(0, c, self.chunk_size):
                self.feed(features[start : start + self.chunk_size])
            return
        x = torch.as_tensor(features, device=self.device)
        log_b = (gmm_log_pdf(self._gmm_params, x) if self._gmm_params is not None
                 else gaussian_log_pdf(self._emission_params, x))
        s = self.composite.num_states
        alpha = (self._alpha if self._alpha is not None
                 else torch.empty((1, s), dtype=torch.float32, device=self.device))
        self._alpha, bp = k4_chunk(alpha, np.array([self._t]), np.array([c]),
                                   log_b[None], self._trans, self._coefs)
        self._bp_chunks.append(bp[0].cpu().numpy())
        self._t += c

    def _backtrace(self, best: int) -> np.ndarray:
        bp = np.concatenate(self._bp_chunks, axis=0)  # (t, S)
        path = np.zeros(self._t, np.int64)
        path[-1] = best
        state = best
        for t in range(self._t - 1, 0, -1):
            state = bp[t, state]
            path[t - 1] = state
        return path

    def partial_scores(self) -> np.ndarray:
        """Current per-exit-state scores (running hypothesis strengths)."""
        alpha = self._alpha[0].cpu().numpy()
        return np.where(self.composite.is_exit, alpha, -np.inf)

    def partial_labels(self, skip_silence: bool = True) -> str:
        """Best decode of everything fed so far (any state may end it)."""
        if self._t == 0:
            return ""
        alpha = self._alpha[0].cpu().numpy()
        best = int(np.argmax(alpha))
        return "".join(
            self.composite.path_to_labels(self._backtrace(best), skip_silence)
        )

    def finalize(self):
        """(score, path) with the offline decoder's termination (best exit)."""
        scores = self.partial_scores()
        best = int(np.argmax(scores))
        return float(scores[best]), self._backtrace(best)
