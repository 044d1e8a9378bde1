"""MAP speaker adaptation: shift trained Gaussian means toward a speaker.

A port of cs304_tpu/models/adapt.py. Classical maximum-a-posteriori
(Gauvain-Lee style) mean adaptation: align a few ENROLLMENT utterances (with
known transcripts) from the target speaker, pool per-(label, state) frame
statistics, and interpolate

    mu' = (tau * mu0 + sum_x) / (tau + count)

so states with little enrollment evidence stay at the speaker-independent
prior (tau = equivalent prior frame count). Covariances and transitions are
left untouched — with seconds of enrollment audio, adapting means only is
the stable regime.

The reference has no adaptation capability at all; its answer to a new
microphone/speaker was retraining from scratch. Statistics come from the
same alignment pass the legacy embedded trainer uses
(models/train_continuous.py _stats_pass: the banded word trellis over the
transcript's sentence, one launch of the sentence kernel on a card, and
integer-histogram counts), summed in float64 on the host.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import fp32_exact, resolve_device
from ..ops.gaussian import gmm_log_pdf, make_gmm_params
from ..ops.viterbi import viterbi_banded_batch
from .hmm import WordHMM
from .train_continuous import _stats_pass


def map_adapt(
    models: Dict[str, WordHMM],
    labeled_features: Dict[str, Sequence[np.ndarray]],
    tau: float = 20.0,
    insert_sil: bool = True,
    cross_word: str = "exit_only",
    adapt_silence: bool = True,
    device=None,
) -> Dict[str, WordHMM]:
    """Adapt word-model means to enrollment data, on ``device`` (the first
    card by default; ``device="cpu"`` for the CPU).

    labeled_features: transcript -> (T_i, D) feature list (the embedded
    trainer's corpus shape — a handful of utterances is enough). K-mixture
    GMMWordHMM dicts adapt per-mixture (responsibility-weighted occupancies,
    see _map_adapt_gmm); mixed Gaussian/GMM dicts are rejected — promote the
    stragglers first.

    adapt_silence=True (default) adapts the silence model from the
    enrollment's aligned silence segments as well: moving the word models
    toward a new channel while silence stays at the prior skews the
    word/silence competition at segment boundaries (the JAX package measured
    insertions flooding the decode that way). Keep them moving together
    unless the enrollment has no real silence.

    Returns a NEW model dict; the input models are not mutated.
    """
    from .gmm_hmm import GMMWordHMM

    if tau <= 0:
        raise ValueError(f"tau must be positive, got {tau}")
    dev = resolve_device(device)
    gmm_flags = [isinstance(m, GMMWordHMM) for m in models.values()]
    if any(gmm_flags):
        if not all(gmm_flags):
            raise ValueError(
                "map_adapt needs a uniform model dict — promote the "
                "single-Gaussian models first (promote_to_gmm)"
            )
        return _map_adapt_gmm(
            models, labeled_features, tau, insert_sil, cross_word,
            adapt_silence, dev,
        )
    counts, sums, labels, _s_max = _enrollment_stats(
        models, labeled_features, insert_sil, cross_word, dev
    )

    out: Dict[str, WordHMM] = {}
    for label, m in models.items():
        if label == "S" and not adapt_silence:
            out[label] = m
            continue
        i = labels.index(label)
        s = m.num_states
        c = counts[i, :s][:, None]  # (S, 1)
        new_means = (tau * m.means + sums[i, :s]) / (tau + c)
        out[label] = WordHMM(
            label=m.label, means=new_means.astype(np.float32),
            covariances=m.covariances, log_a=m.log_a,
        )
    return out


def _map_adapt_gmm(
    models, labeled_features, tau: float, insert_sil: bool, cross_word: str,
    adapt_silence: bool, device,
):
    """Per-mixture MAP mean adaptation for K-mixture models.

    Same alignment as the single-Gaussian path, but each aligned frame is
    soft-assigned across its state's mixtures by the posterior
    responsibilities r_k ∝ w_k N_k(x) (the embedded-GMM trainer's E-step),
    and each mixture's mean interpolates with its own occupancy:
    mu'_{s,k} = (tau mu_{s,k} + Σ r_k x) / (tau + Σ r_k).
    Weights, covariances, and transitions stay at the prior.
    """
    from .gmm_hmm import GMMWordHMM
    from .stacking import enrollment_batches, stack_models

    stacked = stack_models(models, require_silence=insert_sil)
    l_num, s_max = len(stacked.labels), stacked.s_max
    k_max = stacked.weights.shape[-1]
    counts = np.zeros((l_num, s_max, k_max), np.float64)
    sums = np.zeros((l_num, s_max, k_max, stacked.dim), np.float64)
    for topo, log_a_sent, emission, padded in enrollment_batches(
        stacked, labeled_features, insert_sil, cross_word
    ):
        c, sm = _gmm_stats_pass(
            *emission, log_a_sent, topo.lab_of_state, topo.loc_of_state,
            torch.as_tensor(padded.data, device=device),
            torch.as_tensor(padded.lengths, device=device),
            l_num, s_max,
        )
        counts += c.cpu().numpy().astype(np.float64)
        sums += sm.cpu().numpy().astype(np.float64)

    out: Dict[str, GMMWordHMM] = {}
    for label, m in models.items():
        if label == "S" and not adapt_silence:
            out[label] = m
            continue
        i = stacked.label_index[label]
        s, k = m.num_states, m.num_mixtures
        c = counts[i, :s, :k][..., None]  # (S, K, 1)
        new_means = (tau * m.means + sums[i, :s, :k]) / (tau + c)
        out[label] = GMMWordHMM(
            label=m.label, means=new_means.astype(np.float32),
            covariances=m.covariances, weights=m.weights, log_a=m.log_a,
        )
    return out


def _gmm_stats_pass(
    means_sent, covs_sent, weights_sent, log_a_sent, lab_of_state,
    loc_of_state, batch, lengths, num_labels: int, s_max: int,
):
    """Viterbi alignment + mixture-responsibility-weighted zeroth/first-order
    statistics over the sentence state space, on the batch's device.

    Returns (counts (L, S, K), sums (L, S, K, D))."""
    fp32_exact()
    dev = batch.device
    params = make_gmm_params(means_sent, covs_sent, weights_sent, device=dev)
    log_b, weighted = gmm_log_pdf(params, batch, return_components=True)  # (B,T,S), (B,T,S,K)
    _scores, paths = viterbi_banded_batch(
        log_b, torch.as_tensor(log_a_sent, device=dev), lengths)

    b, t, d = batch.shape
    k = weighted.shape[-1]
    f = num_labels * s_max
    path_l = paths.to(torch.int64)
    mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    # Responsibilities of the ALIGNED state's mixtures (zero-weight padding
    # mixtures carry log 0 = -inf and softmax to 0).
    aligned = weighted.gather(2, path_l[:, :, None, None].expand(b, t, 1, k))[:, :, 0, :]
    r = torch.softmax(aligned, dim=-1) * mask[..., None]  # (B, T, K)

    flat_of_state = torch.as_tensor(
        np.asarray(lab_of_state) * s_max + np.asarray(loc_of_state), device=dev
    ).to(torch.int64)
    oh = torch.nn.functional.one_hot(flat_of_state[path_l], f).to(torch.float32)
    counts = torch.einsum("btf,btk->fk", oh, r).reshape(num_labels, s_max, k)
    sums = torch.einsum("btf,btk,btd->fkd", oh, r, batch).reshape(
        num_labels, s_max, k, d)
    return counts, sums


def self_adapt(
    models: Dict[str, WordHMM],
    features: Sequence[np.ndarray],
    tau: float = 1.0,
    penalty: float = -100.0,
    min_confidence: float = 0.7,
    adapt_silence: bool = True,
    device=None,
) -> Tuple[Dict[str, WordHMM], int]:
    """Unsupervised MAP adaptation: no transcripts needed.

    Decodes the given utterances with per-word posterior confidences
    (ContinuousDecoder.predict_batch_with_confidence), keeps only
    utterances whose LEAST confident word clears min_confidence (a wrong
    pseudo-transcript would anchor the statistics to the wrong states, so
    the filter errs conservative), and MAP-adapts on the kept
    (prediction -> features) pairs.

    It helps where the 1-best is mostly right (mild mismatch) and hurts
    where the decoder is confidently wrong, which the confidence filter
    cannot catch: for strong mismatch use supervised map_adapt with true
    transcripts. Small tau is deliberate: when the pseudo-labels are trusted
    at all, trust them nearly fully.

    Returns (adapted models, number of utterances kept). With nothing kept,
    returns the input models unchanged (same objects) and 0.
    """
    from .decoder import ContinuousDecoder

    decoder = ContinuousDecoder(models, penalty=penalty, device=device)
    scored = decoder.predict_batch_with_confidence(
        [np.asarray(f) for f in features]
    )
    labeled: Dict[str, List[np.ndarray]] = {}
    kept = 0
    for feats, words in zip(features, scored):
        if not words:
            continue
        text = "".join(w for w, _s, _e, _c in words)
        confidence = min(c for _w, _s, _e, c in words)
        if text and confidence >= min_confidence:
            labeled.setdefault(text, []).append(np.asarray(feats))
            kept += 1
    if not labeled:
        return models, 0
    return map_adapt(
        models, labeled, tau=tau, adapt_silence=adapt_silence,
        device=decoder.device,
    ), kept


def _enrollment_stats(
    models: Dict[str, WordHMM],
    labeled_features: Dict[str, Sequence[np.ndarray]],
    insert_sil: bool,
    cross_word: str,
    device,
) -> Tuple[np.ndarray, np.ndarray, List[str], int]:
    """Pooled per-(label, state) frame counts and sums from Viterbi
    alignments of the enrollment utterances."""
    from .stacking import enrollment_batches, stack_models

    stacked = stack_models(models, require_silence=insert_sil)
    l_num, s_max = len(stacked.labels), stacked.s_max
    counts = np.zeros((l_num, s_max), np.float64)
    sums = np.zeros((l_num, s_max, stacked.dim), np.float64)
    for topo, log_a_sent, emission, padded in enrollment_batches(
        stacked, labeled_features, insert_sil, cross_word
    ):
        c, sm, _tr, _paths = _stats_pass(
            *emission, log_a_sent, topo.lab_of_state, topo.loc_of_state,
            topo.pos_of_state,
            torch.as_tensor(padded.data, device=device),
            torch.as_tensor(padded.lengths, device=device),
            l_num, s_max,
        )
        counts += c.cpu().numpy().astype(np.float64)
        sums += sm.cpu().numpy().astype(np.float64)
    return counts, sums, stacked.labels, s_max
