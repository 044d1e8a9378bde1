"""Isolated-word classifier: score a clip under every word model, argmax.

The reference loops 11 models per clip and ships clips to worker processes
(model_collection.py:23-28, scripts/project3_predict_simple.py:23-27). A
port of cs304_tpu/models/collection.py: all models' states stack into one
(M*S) Gaussian set, so the whole (B clips x M models) score table is one
batched whitening emission product and ONE banded word trellis over B*M rows
(ops/viterbi.viterbi_banded_batch), each row with its own model's
transitions: on a card, one launch of the sentence kernel's decode mode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..data.batching import pad_batch
from ..device import resolve_device
from ..ops.gaussian import gaussian_log_pdf, make_gaussian_params
from ..ops.viterbi import viterbi_banded_batch
from .hmm import WordHMM


@dataclass
class ModelCollection:
    """Ordered set of word models with equal state counts, scored on
    ``device`` (the first card by default; ``device="cpu"`` for the CPU)."""

    labels: List[str]
    means: np.ndarray  # (M, S, D)
    covariances: np.ndarray  # (M, S, D, D)
    log_a: np.ndarray  # (M, S, S)
    device: object = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        m, s, d = self.means.shape
        self._params = make_gaussian_params(
            np.asarray(self.means, np.float32).reshape(m * s, d),
            np.asarray(self.covariances, np.float32).reshape(m * s, d, d),
            device=self.device)
        self._log_a = torch.as_tensor(np.asarray(self.log_a, np.float32),
                                      device=self.device)

    @classmethod
    def from_models(cls, models: Sequence[WordHMM], device=None) -> "ModelCollection":
        counts = {m.num_states for m in models}
        if len(counts) != 1:
            raise ValueError(f"state counts differ across models: {counts}")
        return cls(
            labels=[m.label for m in models],
            means=np.stack([m.means for m in models]),
            covariances=np.stack([m.covariances for m in models]),
            log_a=np.stack([m.log_a for m in models]),
            device=device,
        )

    @property
    def num_models(self) -> int:
        return self.means.shape[0]

    @property
    def num_states(self) -> int:
        return self.means.shape[1]

    def score_batch(self, features: Sequence[np.ndarray]) -> np.ndarray:
        """(B clips) -> (B, M) Viterbi scores under every model."""
        padded = pad_batch([np.asarray(f, np.float32) for f in features], 128)
        scores = _score_all(
            self._params, self._log_a,
            torch.as_tensor(padded.data, device=self.device),
            torch.as_tensor(padded.lengths, device=self.device),
        )
        return scores.cpu().numpy()

    def predict_batch(self, features: Sequence[np.ndarray]) -> List[str]:
        """argmax label per clip; ties go to the first (lowest-index) label,
        matching the reference's stable sort over the label dict
        (model_collection.py:24-28)."""
        scores = self.score_batch(features)
        return [self.labels[i] for i in np.argmax(scores, axis=1)]

    def predict(self, features) -> str:
        return self.predict_batch([np.asarray(features)])[0]


def _score_all(params, log_a, batch, lengths):
    """params over the M*S stacked Gaussians, log_a (M, S, S), batch
    (B, T, D), lengths (B,) -> (B, M) scores: row b*M + m of the trellis is
    clip b under model m."""
    m, s, _ = log_a.shape
    b, t, _d = batch.shape
    log_b = gaussian_log_pdf(params, batch).reshape(b, t, m, s)
    log_b = log_b.permute(0, 2, 1, 3).reshape(b * m, t, s)
    rows_a = log_a[None].expand(b, m, s, s).reshape(b * m, s, s)
    scores, _paths = viterbi_banded_batch(
        log_b, rows_a, lengths.repeat_interleave(m))
    return scores.reshape(b, m)
