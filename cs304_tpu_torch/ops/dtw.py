"""Multi-template dynamic time warping over a column recursion.

A port of cs304_tpu/ops/dtw.py. The reference's DTW (dynamic_time_wrapping.py)
concatenates all template MFCCs into one trellis with per-word start rows,
moves {insertion (same row), diagonal, super-diagonal skipping one template
row}, per-column beam pruning at column_min * (1 + pruning_factor) using the
PREVIOUS column's min (dynamic_time_wrapping.py:89-95), and scores each word
at its final row in the last column. Here the frame-distance matrix is one
float32 matmul (||a-b||^2 = ||a||^2 + ||b||^2 - 2ab), and the column
recursion is, on a card, ONE launch of the hand-written column kernel
(ops/cuda/dtw.py, csrc/dtw.cu); on CPU tensors it is dtw_columns_plain, a
torch loop over the columns and the kernel's bitwise specification.

Documented divergences from the reference's literal code (both are defects
the JAX package does not replicate either):
- its row loop starts one row early, overwriting each word's boundary row
  with a distance computed against the PREVIOUS word's last frame (and for
  the first word, sequences[-1] — Python wraparound)
  (dynamic_time_wrapping.py:79-81);
- its final score reads row start+length-1 of the (H+1)-row matrix, i.e.
  the second-to-last frame of each template (:110-113).
Here each word's rows are exactly its template frames and the score is its
true last row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..device import fp32_exact, resolve_device, upload

INF = float("inf")


def pairwise_euclidean(a: torch.Tensor, b: torch.Tensor,
                       b_sq: torch.Tensor | None = None,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) Euclidean distances between the rows of a
    and of b via one float32 matmul (TF32 off); the recognizer passes the
    sample as a and the templates as b, for (L, H). ``b_sq``: b's squared
    row norms, ``torch.sum(b * b, dim=1)``, where the caller keeps them;
    ``out``: an (N, M) tensor (or view) the distances are written to."""
    fp32_exact()
    a2 = torch.sum(a * a, dim=1)[:, None]
    if b_sq is None:
        b_sq = torch.sum(b * b, dim=1)
    cross = a @ b.T
    return torch.sqrt(torch.clamp(a2 + b_sq[None, :] - 2.0 * cross, min=0.0), out=out)


def dtw_columns_plain(dist_t, is_first, is_second, end_rows, pruning: bool = True,
                      pruning_factor: float = 4.0):
    """The column recursion, plain: dist_t (L, H) float32 (row j = sample
    frame j against every template row), is_first / is_second (H,) bool,
    end_rows (W,) int -> (W,) float32 accumulated distances. The bitwise
    specification of the column kernel (csrc/dtw.cu): a min, a compare and
    one float32 add a cell, the prune threshold prev_min * (1 + factor) with
    the factor's sum taken first."""
    h = dist_t.shape[1]
    dev = dist_t.device
    is_first = torch.as_tensor(is_first, device=dev).to(torch.bool)
    is_second = torch.as_tensor(is_second, device=dev).to(torch.bool)
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    scale = (torch.tensor(1.0, dtype=torch.float32, device=dev)
             + torch.tensor(pruning_factor, dtype=torch.float32, device=dev))
    prev = torch.full((h,), INF, dtype=torch.float32, device=dev)
    prev_min = inf
    for j in range(dist_t.shape[0]):
        # Fresh word starts are only allowed at the first sample column.
        boundary = torch.zeros_like(inf) if j == 0 else inf
        diag = torch.where(is_first, boundary, torch.roll(prev, 1))
        superdiag = torch.where(is_first, inf,
                                torch.where(is_second, boundary, torch.roll(prev, 2)))
        new = dist_t[j] + torch.minimum(prev, torch.minimum(diag, superdiag))
        if pruning:
            new = torch.where(new > prev_min * scale, inf, new)
        prev_min = torch.min(new)
        prev = new
    return prev[torch.as_tensor(end_rows, device=dev).to(torch.int64)]


def dtw_multi_template(dist, is_first, is_second, end_rows, pruning: bool = True,
                       pruning_factor: float = 4.0):
    """Run the multi-template trellis over a (H, L) distance matrix.

    is_first/is_second: (H,) bools marking each word's first/second row.
    end_rows: (W,) int32 last row of each word.
    Returns (W,) accumulated distances (word w aligned over the full sample),
    on dist's device: the column kernel on a CUDA tensor (after a transpose
    to its column-major layout, rows 16 bytes aligned), dtw_columns_plain on
    a CPU one."""
    from .cuda.dtw import aligned_rows, dtw_columns

    dev = dist.device
    return dtw_columns(
        aligned_rows(dist.shape[1], dist.shape[0], dev).copy_(dist.T),
        torch.as_tensor(is_first, device=dev), torch.as_tensor(is_second, device=dev),
        torch.as_tensor(end_rows, device=dev).to(torch.int32), pruning=pruning,
        pruning_factor=pruning_factor)


@dataclass
class DTWRecognizer:
    """Template-based isolated-word recognizer (reference DynamicTimeWarping),
    on ``device`` (the first card by default; ``device="cpu"`` for the CPU).

    Build once from per-word template feature sequences, then `search` samples.
    """

    word_lengths: List[int]
    templates: np.ndarray  # (H, D) concatenated template features
    pruning: bool = True
    pruning_factor: float = 4.0
    device: object = None

    @classmethod
    def from_features(
        cls, template_features: Sequence[np.ndarray], **kwargs
    ) -> "DTWRecognizer":
        lengths = [int(f.shape[0]) for f in template_features]
        return cls(
            word_lengths=lengths,
            templates=np.concatenate(
                [np.asarray(f, np.float32) for f in template_features]
            ),
            **kwargs,
        )

    def __post_init__(self) -> None:
        # The column kernel gathers each word's last row unchecked: with no
        # empty template, every one lies in [0, H).
        if not self.word_lengths or min(self.word_lengths) < 1:
            raise ValueError(f"every template needs at least one frame: word lengths "
                             f"{list(self.word_lengths)}")
        self.device = resolve_device(self.device)
        starts = np.cumsum([0] + self.word_lengths[:-1])
        h = sum(self.word_lengths)
        is_first = np.zeros(h, bool)
        is_first[starts] = True
        seconds = starts + 1
        is_second = np.zeros(h, bool)
        is_second[seconds[seconds < h]] = True
        end_rows = (starts + np.asarray(self.word_lengths) - 1).astype(np.int32)
        dev = self.device
        self._templates = torch.as_tensor(np.asarray(self.templates, np.float32), device=dev)
        # Every search's distances use the templates' squared norms: kept.
        self._templates_sq = torch.sum(self._templates * self._templates, dim=1)
        self._is_first = torch.as_tensor(is_first.astype(np.uint8), device=dev)
        self._is_second = torch.as_tensor(is_second.astype(np.uint8), device=dev)
        self._end_rows = torch.as_tensor(end_rows, device=dev)

    def distances(self, sample_features: np.ndarray) -> np.ndarray:
        """(W,) alignment costs of the sample against every template word.
        The distances come out column-major, (L, H), as the column
        recursion reads them, in rows 16 bytes aligned (``aligned_rows``)."""
        from .cuda.dtw import aligned_rows, dtw_columns

        sample = upload(np.asarray(sample_features, np.float32), self.device)
        dist_t = pairwise_euclidean(
            sample, self._templates, self._templates_sq,
            out=aligned_rows(sample.shape[0], self._templates.shape[0], self.device))
        out = dtw_columns(dist_t, self._is_first, self._is_second, self._end_rows,
                          pruning=self.pruning, pruning_factor=self.pruning_factor)
        return out.cpu().numpy()

    def search(self, sample_features: np.ndarray):
        """Best (word index, distance), like DynamicTimeWarping.search
        (dynamic_time_wrapping.py:66-116)."""
        d = self.distances(sample_features)
        idx = int(np.argmin(d))
        return idx, float(d[idx])
