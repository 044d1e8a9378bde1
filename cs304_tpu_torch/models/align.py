"""Forced alignment: word/state time alignment of a KNOWN transcript.

A port of cs304_tpu/models/align.py. The reference aligns transcripts
internally during embedded training (hidden_markov_model.py:584-664 —
sentence Viterbi + _remux_path_and_signal cuts the path at word boundaries)
but never exposes the timings to a user. Given features (or audio) and its
transcript, this returns per-word and per-state segments with frame and
second timestamps, plus the alignment score.

The alignment uses exactly the training-time sentence topology
(models/train_continuous.py _topology/_sentence_log_a) and the banded word
trellis (ops/viterbi.viterbi_banded_batch: on a card one launch of the
sentence kernel's decode mode), so `ForcedAligner` timings are the
segmentation the embedded trainer would assign. An utterance too short to
reach the sentence's last state scores -inf; its path is then whatever the
trellis's tie rule leaves (ROADMAP W3) and carries no timing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..data.batching import pad_batch
from ..device import resolve_device
from ..ops.gaussian import (
    gaussian_log_pdf,
    gmm_log_pdf,
    make_gaussian_params,
    make_gmm_params,
)
from ..ops.viterbi import viterbi_banded_batch


@dataclass(frozen=True)
class StateSegment:
    """One HMM state's frame run inside a word segment."""

    state: int  # local state index within the word model
    start_frame: int
    end_frame: int  # exclusive


@dataclass(frozen=True)
class WordSegment:
    """One aligned word occurrence."""

    word: str
    position: int  # index into the (silence-interleaved) sentence
    start_frame: int
    end_frame: int  # exclusive
    start_s: float
    end_s: float
    states: List[StateSegment] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


@dataclass(frozen=True)
class AlignResult:
    transcript: str  # the user transcript ("375")
    sentence: str  # the aligned sentence ("S3S7S5S" with silence interleave)
    score: float  # Viterbi log-likelihood of the alignment
    num_frames: int
    words: List[WordSegment]  # all sentence positions, silence included

    def word_segments(self, include_silence: bool = False) -> List[WordSegment]:
        if include_silence:
            return list(self.words)
        return [w for w in self.words if w.word != "S"]


class ForcedAligner:
    """Aligns utterances against known transcripts with trained word models,
    on ``device`` (the first card by default; ``device="cpu"`` for the CPU).

    Accepts the same model dict the decoder/trainers use (single-Gaussian
    WordHMM, K-mixture GMMWordHMM, or a mix). `insert_sil=True` interleaves
    the silence model exactly like embedded training (reference
    insert_silence, hidden_markov_model.py:794-797); `cross_word` picks the
    sentence topology ("exit_only" = the decoder's actual topology, "band" =
    the reference's accidental free band — see
    ContinuousTrainConfig.cross_word).
    """

    def __init__(
        self,
        models: Dict[str, object],
        insert_sil: bool = True,
        cross_word: str = "exit_only",
        hop_s: float = 160.0 / 16000.0,
        device=None,
    ) -> None:
        from .stacking import stack_models

        self.insert_sil = insert_sil
        if cross_word not in ("exit_only", "band"):
            raise ValueError(f"unknown cross_word {cross_word!r}")
        self.cross_word = cross_word
        self.hop_s = float(hop_s)
        self.device = resolve_device(device)
        self._stack = stack_models(models, require_silence=insert_sil)
        self.labels = self._stack.labels
        self._is_gmm = self._stack.is_gmm

    # -- alignment -----------------------------------------------------------
    def align(self, features: np.ndarray, transcript: str) -> AlignResult:
        """Align one (T, 39) feature matrix against its transcript."""
        return self.align_batch([np.asarray(features)], transcript)[0]

    def align_batch(
        self, features: Sequence[np.ndarray], transcript: str
    ) -> List[AlignResult]:
        """Align a ragged list of feature matrices that share one transcript
        (the shape embedded training consumes: all takes of one sentence)."""
        if not features:
            raise ValueError("no utterances to align")
        features = [np.asarray(f) for f in features]
        for i, f in enumerate(features):
            if f.ndim != 2 or f.shape[0] == 0:
                raise ValueError(
                    f"utterance {i}: expected a non-empty (T, D) feature "
                    f"matrix, got shape {f.shape} (too-short audio can "
                    "yield zero frames)"
                )
        sentence, topo, log_a, emission = self._stack.sentence_for(
            transcript, self.insert_sil, self.cross_word
        )
        padded = pad_batch([f.astype(np.float32) for f in features], 128)
        scores, paths = _align_device(
            emission, log_a, padded.data, padded.lengths, self.device)
        scores = scores.cpu().numpy()
        paths = paths.cpu().numpy()
        out = []
        for i, length in enumerate(padded.lengths):
            words = _segments_from_path(
                paths[i, :length], topo, sentence, self.hop_s
            )
            out.append(
                AlignResult(
                    transcript=transcript,
                    sentence=sentence,
                    score=float(scores[i]),
                    num_frames=int(length),
                    words=words,
                )
            )
        return out

    def align_signals(
        self,
        signals: Sequence[np.ndarray],
        transcript: str,
        sample_rate: float = 16000.0,
        cfg=None,
    ) -> List[AlignResult]:
        """Align raw audio: runs the MFCC front-end, then align_batch."""
        from ..ops.mfcc import mfcc_batch

        feats = mfcc_batch(
            [np.asarray(s) for s in signals], sample_rate, cfg=cfg,
            device=self.device,
        )
        return self.align_batch(feats, transcript)


def _align_device(emission, log_a, batch, lengths, device):
    """Gaussian (means, covs) or GMM (means, covs, weights) sentence
    emissions of a padded batch, then the banded trellis -> (scores (B,),
    paths (B, T) int32) on device."""
    batch = torch.as_tensor(batch, device=device)
    if len(emission) == 3:
        log_b = gmm_log_pdf(make_gmm_params(*emission, device=device), batch)
    else:
        log_b = gaussian_log_pdf(make_gaussian_params(*emission, device=device), batch)
    return viterbi_banded_batch(
        log_b, torch.as_tensor(log_a, device=device),
        torch.as_tensor(lengths, device=device))


def _segments_from_path(
    path: np.ndarray, topo, sentence: str, hop_s: float
) -> List[WordSegment]:
    """Path over sentence states -> word segments with per-state runs.

    Mirrors the reference's _remux_path_and_signal boundary walk
    (hidden_markov_model.py:602-636) but yields frame ranges instead of
    copied frame lists. Positions the path never visits (possible only for
    skipped one-state words under the skip-2 band) are omitted."""
    path = np.asarray(path)
    pos = topo.pos_of_state[path]
    loc = topo.loc_of_state[path]
    t = len(path)
    # Run-length boundaries of the position sequence.
    change = np.flatnonzero(np.diff(pos)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [t]])
    words: List[WordSegment] = []
    for s, e in zip(starts, ends):
        p = int(pos[s])
        # State runs inside this word occurrence.
        lrun = loc[s:e]
        lchange = np.flatnonzero(np.diff(lrun)) + 1
        lstarts = np.concatenate([[0], lchange]) + s
        lends = np.concatenate([lchange, [e - s]]) + s
        states = [
            StateSegment(int(lrun[int(ls) - s]), int(ls), int(le))
            for ls, le in zip(lstarts, lends)
        ]
        words.append(
            WordSegment(
                word=sentence[p],
                position=p,
                start_frame=int(s),
                end_frame=int(e),
                start_s=float(s * hop_s),
                end_s=float(e * hop_s),
                states=states,
            )
        )
    return words
