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

Search (ROADMAP item 19): ``bigram=`` (a WordBigram, weighed by
``lm_weight``) replaces the flat inter-word penalty by per-pair penalties
(ops/lm.word_pair_penalties), and ``beam=`` prunes each step. With either,
"auto" (on the card), "scanfree" and "pallas" run the LM or BEAM decode
mode of the scan-free team kernel (ops/cuda/trellis_scanfree.py:
scanfree_decode_lm / scanfree_decode_beam; LM and beam together are the LM
mode with its beam); "fast" runs their plain version, as asked; "scan" with
a bigram alone runs the dense plain path on the (S, S) pair matrix
(ops/lm.pair_penalty_matrix), as the JAX decoder's "scan" does, and "scan"
with a beam the banded semantics (the JAX decoder switches to "fast" there
and reports it; this one keeps the name it was given). The n-best, lattice
confidence, counted, duration and grammar decodes use the flat penalty, as
in the JAX package: predict_nbest (ops/nbest.py; the KBEST kernel on the
card), predict_batch_with_confidence (ops/lattice.py; K4 + K2-bt, then the
LSUM kernel on the card), predict_batch_counted (ops/viterbi_counted.py)
and predict_batch_grammar (ops/grammar.py; the PLANES kernel on the card),
predict_batch_duration (ops/viterbi_duration.py; the DURATION kernel); on
the CPU each runs its plain version, a batched PyTorch step in a Python
loop over T.
"""
from __future__ import annotations

import logging
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
from ..ops.cuda.trellis_scanfree import (
    MAX_STATES,
    scanfree_decode,
    scanfree_decode_beam,
    scanfree_decode_lm,
)
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
    lm_tables,
    pack_coefs,
    viterbi_composite_batch_fast,
)
from ..ops.words import ids_to_strings, words_from_paths
from .hmm import DEFAULT_WORD_PENALTY, WordHMM, stack_word_models

logger = logging.getLogger(__name__)

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
        if beam is not None and beam <= 0:
            raise ValueError(f"beam must be positive, got {beam}")
        self.device = resolve_device(device)
        if backend == "auto":
            backend = "scanfree" if self.device.type == "cuda" else "fast"
        self.backend = backend
        self.beam = beam
        self.emissions = emissions
        self.emission_precision = emission_precision
        # The bigram LM and its weight (with no bigram the weight changes
        # nothing, as in the JAX decoder).
        self._bigram = bigram
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
        self._lm = self._lm_tables()
        self._trans = self._dense_trans()
        self._lowers = torch.as_tensor(c.lowers, dtype=torch.int32, device=dev)
        self._uppers = torch.as_tensor(c.uppers, dtype=torch.int32, device=dev)

    @property
    def penalty(self) -> float:
        return self.composite.penalty

    @penalty.setter
    def penalty(self, value: float) -> None:
        self.composite.penalty = value
        self._lm = self._lm_tables()
        self._trans = self._dense_trans()

    def _searching(self) -> bool:
        return self._bigram is not None or self.beam is not None

    def _lm_tables(self):
        """The bigram's (W, W) pair penalties (lm_weight and the penalty
        folded in) with word_of_state and uppers on the device, or None."""
        if self._bigram is None:
            return None
        from ..ops.lm import word_pair_penalties

        c = self.composite
        return lm_tables(word_pair_penalties(c, self._bigram, self._lm_weight),
                         c.word_of_state, c.uppers, device=self.device)

    def _dense_trans(self):
        """The (S, S) transition matrix of the dense backends, which carries
        the penalty (the (S, S) pair matrix of a bigram on "scan"); None for
        the banded ones and for a search on "pallas" (the LM / BEAM mode)."""
        if self.backend not in ("scan", "pallas") or (
                self._searching() and not (self.backend == "scan" and self.beam is None)):
            return None
        c = self.composite
        penalty = c.penalty
        if self._bigram is not None:
            from ..ops.lm import pair_penalty_matrix

            penalty = pair_penalty_matrix(c, self._bigram, self._lm_weight)
        return composite_transition_matrix(c.log_a, c.lower_of_state, c.is_entry,
                                           c.is_exit, penalty, device=self.device)

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
        if self._searching() and self._trans is None:
            if self.backend in ("scanfree", "pallas"):
                if self._lm is not None:
                    return scanfree_decode_lm(log_b, self._coefs, self._lm, lengths,
                                              beam=self.beam)
                return scanfree_decode_beam(log_b, self._coefs, c.penalty, lengths,
                                            self.beam)
            pair, word_of_state, uppers = self._lm or (None, None, None)
            return viterbi_composite_batch_fast(
                log_b, c.log_a, c.lower_of_state, c.is_entry, c.is_exit, c.penalty,
                lengths, pair_penalty=pair, word_of_state=word_of_state, uppers=uppers,
                beam=self.beam)
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

    def _dispatch(self, features: Sequence[np.ndarray], skip_silence: bool = True):
        """Queue one batch (128-padded): decode and word compaction on the
        device; returns the handles without waiting for them."""
        padded = pad_batch([np.asarray(f) for f in features], 128)
        batch, lengths = self._to_device(padded)
        _scores, paths = self.decode(batch, lengths)
        ids, counts = self._words(paths, lengths, skip_silence)
        return ids, counts, paths, padded.lengths, skip_silence

    def _consume(self, handles) -> List[str]:
        """Read a dispatched batch back as label strings; a transcript longer
        than the word buffer is read from the full path on the host."""
        ids, counts, paths, lengths, skip_silence = handles
        c = self.composite
        try:
            return ids_to_strings(ids.cpu().numpy(), counts.cpu().numpy(), c.labels)
        except ValueError:
            paths_np = paths.cpu().numpy()
            return ["".join(c.path_to_labels(paths_np[row, :n], skip_silence))
                    for row, n in enumerate(lengths)]

    def predict_batch(
        self, features: Sequence[np.ndarray], skip_silence: bool = True
    ) -> List[str]:
        """Decode a ragged list of (T_i, D) features to label strings, one
        device batch per 128-frame length bucket."""
        out: List[str] = [""] * len(features)
        for idx in self._buckets(features):
            strings = self._consume(self._dispatch([features[i] for i in idx], skip_silence))
            for i, s in zip(idx, strings):
                out[i] = s
        return out

    def predict_batches(self, feature_batches, skip_silence: bool = True):
        """Generator over batches of feature lists, double-buffered: batch
        i + 1 is queued on the device before batch i is read back, so the
        card works while the host consumes."""
        pending = None
        for features in feature_batches:
            handles = self._dispatch(features, skip_silence)
            if pending is not None:
                yield self._consume(pending)
            pending = handles
        if pending is not None:
            yield self._consume(pending)

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

    # -- search beside the 1-best decode ---------------------------------------
    def _emissions(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, T, D) padded features on the device -> (B, T, S) log
        densities of the decoder's emission model: GMMs by whitening, single
        Gaussians by the quad form at the decoder's tier (tier_emission) or
        by whitening, as ``emissions`` says."""
        return self._log_b(batch, whiten=True)[..., : self.composite.num_states]

    def _constrained(self, features, run, skip_silence: bool, what: str) -> List[str]:
        """Shared tail of the counted / duration / grammar decodes: emissions
        of the 128-padded batch, run(log_b, lengths) -> (scores, paths), and
        the unconstrained decode for every utterance whose score is -inf."""
        c = self.composite
        padded = pad_batch([np.asarray(f) for f in features], 128)
        batch, lengths = self._to_device(padded)
        scores, paths = run(self._emissions(batch), lengths)
        scores = scores.cpu().numpy()
        paths = paths.cpu().numpy()
        fallback_idx = [i for i in range(len(features)) if not np.isfinite(scores[i])]
        fallbacks = {}
        if fallback_idx:
            logger.info("%s decode: %d utterance(s) have no admissible path; falling "
                        "back to unconstrained", what, len(fallback_idx))
            preds = self.predict_batch([features[i] for i in fallback_idx], skip_silence)
            fallbacks = dict(zip(fallback_idx, preds))
        return [fallbacks[i] if i in fallbacks else
                "".join(c.path_to_labels(paths[i, : padded.lengths[i]],
                                         skip_silence=skip_silence))
                for i in range(len(features))]

    def predict_batch_counted(self, features: Sequence[np.ndarray], n_words: int,
                              skip_silence: bool = True) -> List[str]:
        """Decode constrained to exactly n_words non-silence words
        (ops/viterbi_counted.py); utterances with no such path fall back to
        the unconstrained decode. Flat penalty (no bigram here)."""
        from ..ops.viterbi_counted import viterbi_composite_counted_batch

        c = self.composite
        counted = c.word_of_state != (c._silence_word if c._silence_word is not None else -1)

        def run(log_b, lengths):
            return viterbi_composite_counted_batch(
                log_b, c.log_a, c.lower_of_state, c.is_entry, c.is_exit, counted,
                c.penalty, n_words, lengths)

        return self._constrained(features, run, skip_silence, "counted")

    def predict_batch_duration(self, features: Sequence[np.ndarray], min_duration=2,
                               max_duration=None, skip_silence: bool = True,
                               constrain_silence: bool = False) -> List[str]:
        """Decode under state-duration floors / ceilings
        (ops/viterbi_duration.py): min_duration and max_duration an int or
        {label: int}; utterances with no feasible path fall back to the
        unconstrained decode. Flat penalty (no bigram here)."""
        from ..ops.viterbi_duration import duration_arrays, viterbi_composite_duration_batch

        c = self.composite
        min_dur, max_dur, d_cap = duration_arrays(c, min_duration, max_duration,
                                                  constrain_silence)

        def run(log_b, lengths):
            return viterbi_composite_duration_batch(
                log_b, c.log_a, c.lower_of_state, c.is_entry, c.is_exit, c.penalty,
                min_dur, max_dur, lengths, d_cap=d_cap)

        return self._constrained(features, run, skip_silence, "duration")

    def predict_batch_grammar(self, features: Sequence[np.ndarray], grammar,
                              skip_silence: bool = True) -> List[str]:
        """Decode constrained to the word sequences a WordDFA accepts
        (ops/grammar.py); utterances with no accepted path fall back to the
        unconstrained decode. Flat penalty (no bigram here)."""
        from ..ops.grammar import viterbi_composite_grammar_batch

        c = self.composite
        if list(grammar.labels) != list(c.labels):
            raise ValueError(f"grammar vocabulary {grammar.labels} does not match the "
                             f"decoder's labels {c.labels}")

        def run(log_b, lengths):
            return viterbi_composite_grammar_batch(
                log_b, c.log_a, c.lower_of_state, c.is_entry, c.is_exit, c.word_of_state,
                grammar.next_state, grammar.accept, c.penalty, lengths)

        return self._constrained(features, run, skip_silence, "grammar")

    def _gmm_log_b(self, features):
        """GMM log densities of one (T, D) utterance on the device (the
        whitening layout), or None for single Gaussians."""
        if self._gmm is None:
            return None
        x = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
        return gmm_log_pdf(self._gmm_whiten, x)

    def predict_nbest(self, features, n: int = 4, beam_k: int | None = None):
        """N-best word strings for one utterance: [(score, text), ...]
        (ops/nbest.py: the KBEST kernel on the card, then the backtrace on
        the host), scored with the decoder's densities (GMMs' own) and
        the flat penalty; apply a bigram afterwards with
        ops.lm.rescore_nbest."""
        from ..ops.nbest import nbest_decode

        return nbest_decode(self.composite, features, n=n, beam_k=beam_k,
                            log_b=self._gmm_log_b(features), device=self.device)

    def predict_batch_with_confidence(self, features: Sequence[np.ndarray],
                                      skip_silence: bool = True):
        """Batched decode with per-word posterior confidences:
        [[(label, start, end, confidence), ...] per utterance]
        (ops/lattice.word_confidences_batch: the dense max-plus decode, K4 +
        K2-bt on the card, and the sum-semiring passes, the LSUM kernel), under the
        flat-penalty measure; GMM-aware."""
        from ..ops.lattice import word_confidences_batch

        log_b = None
        if self._gmm is not None:
            log_b = [self._gmm_log_b(f) for f in features]
        return word_confidences_batch(self.composite, features, log_b=log_b,
                                      skip_silence=skip_silence, device=self.device)

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
