"""Alignment debugging views over Viterbi paths.

The reference prints run-length path strings, per-state count tables
(tabulate), and state histograms (uniplot) from its Signal containers
(signal.py:93-130). Same views here, over plain path arrays, with no
extra dependencies (ASCII rendering).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def run_length(path: Sequence[int]) -> List[Tuple[int, int]]:
    """[(state, run_length), ...] — the reference's show_viterbi_path_str
    content (signal.py:115-130)."""
    path = list(path)
    if not path:
        return []
    out: List[Tuple[int, int]] = []
    last, count = int(path[0]), 1
    for p in path[1:]:
        if int(p) == last:
            count += 1
        else:
            out.append((last, count))
            last, count = int(p), 1
    out.append((last, count))
    return out


def path_string(path: Sequence[int]) -> str:
    """e.g. '0x3 1x7 2x12 4x5'."""
    return " ".join(f"{s}x{n}" for s, n in run_length(path))


def state_counts(paths: Sequence[Sequence[int]], num_states: int) -> np.ndarray:
    """Pooled per-state frame counts (reference show_viterbi_path_table,
    signal.py:93-107)."""
    counts = np.zeros(num_states, np.int64)
    for path in paths:
        idx, c = np.unique(np.asarray(path), return_counts=True)
        counts[idx] += c
    return counts


def count_table(paths: Sequence[Sequence[int]], num_states: int) -> str:
    counts = state_counts(paths, num_states)
    width = max(len(str(int(counts.max()))), 5) if len(counts) else 5
    lines = [f"{'State':>5} | {'Count':>{width}}", "-" * (8 + width)]
    lines += [f"{s:>5} | {int(c):>{width}}" for s, c in enumerate(counts)]
    return "\n".join(lines)


def histogram(paths: Sequence[Sequence[int]], num_states: int, width: int = 50) -> str:
    """ASCII per-state occupancy bars (reference show_viterbi_path_histogram,
    signal.py:109-113)."""
    counts = state_counts(paths, num_states)
    top = max(int(counts.max()), 1)
    lines = []
    for s, c in enumerate(counts):
        bar = "#" * int(round(width * int(c) / top))
        lines.append(f"{s:>3} |{bar} {int(c)}")
    return "\n".join(lines)
