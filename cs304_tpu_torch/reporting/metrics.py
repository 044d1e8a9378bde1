"""Word-error-rate metrics (a copy of cs304_tpu/reporting/metrics.py: plain
Python, no NumPy).

The reference computes only exact-sequence accuracy (e.g.
scripts/project5_test_ndigits_no_sil.py:44-49: `truth == predict` counts);
WER distinguishes a one-word slip from a total miss and decomposes errors
into substitutions / insertions / deletions. The Levenshtein alignment runs
on the host (token sequences are a handful of words; the device has nothing
to add), with the corpus aggregate the phone-tier evaluation prints next to
exact-sequence accuracy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

__all__ = ["EditOps", "edit_ops", "align", "wer", "corpus_wer"]


@dataclass(frozen=True)
class EditOps:
    substitutions: int
    insertions: int
    deletions: int

    @property
    def total(self) -> int:
        return self.substitutions + self.insertions + self.deletions


def _dp(ref: Sequence[str], hyp: Sequence[str]):
    """Levenshtein DP table (unit costs). Rows index ref, columns hyp."""
    n, m = len(ref), len(hyp)
    dist = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        dist[i][0] = i
    for j in range(1, m + 1):
        dist[0][j] = j
    for i in range(1, n + 1):
        ri = ref[i - 1]
        row, prev = dist[i], dist[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ri != hyp[j - 1])
            row[j] = min(sub, prev[j] + 1, row[j - 1] + 1)
    return dist


def align(ref: Sequence[str], hyp: Sequence[str]
          ) -> List[Tuple[str, str | None, str | None]]:
    """Minimum-edit alignment as [(op, ref_token, hyp_token)] with op in
    {"match", "sub", "ins", "del"}. Ties resolve sub > del > ins (the
    conventional backtrace order)."""
    dist = _dp(ref, hyp)
    out: List[Tuple[str, str | None, str | None]] = []
    i, j = len(ref), len(hyp)
    while i > 0 or j > 0:
        if i > 0 and j > 0 and (
            dist[i][j] == dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1])
        ):
            op = "match" if ref[i - 1] == hyp[j - 1] else "sub"
            out.append((op, ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and dist[i][j] == dist[i - 1][j] + 1:
            out.append(("del", ref[i - 1], None))
            i -= 1
        else:
            out.append(("ins", None, hyp[j - 1]))
            j -= 1
    out.reverse()
    return out


def edit_ops(ref: Sequence[str], hyp: Sequence[str]) -> EditOps:
    """Substitution/insertion/deletion counts of the minimum edit path."""
    counts = {"sub": 0, "ins": 0, "del": 0}
    for op, _r, _h in align(ref, hyp):
        if op in counts:
            counts[op] += 1
    return EditOps(counts["sub"], counts["ins"], counts["del"])


def wer(ref: Sequence[str], hyp: Sequence[str]) -> float:
    """Word error rate of one pair: edits / len(ref). A non-empty
    hypothesis against an empty reference counts its insertions over a
    denominator of 1 (the usual convention so the value stays finite)."""
    ops = edit_ops(ref, hyp)
    return ops.total / max(len(ref), 1)


def corpus_wer(pairs: Sequence[Tuple[Sequence[str], Sequence[str]]]
               ) -> Dict[str, float]:
    """Aggregate WER over (ref, hyp) pairs: total edits / total ref words
    (NOT the mean of per-utterance rates), with the error breakdown."""
    sub = ins = dl = ref_words = 0
    for ref, hyp in pairs:
        ops = edit_ops(ref, hyp)
        sub += ops.substitutions
        ins += ops.insertions
        dl += ops.deletions
        ref_words += len(ref)
    denom = max(ref_words, 1)
    return {
        "wer": (sub + ins + dl) / denom,
        "substitutions": sub,
        "insertions": ins,
        "deletions": dl,
        "ref_words": ref_words,
    }
