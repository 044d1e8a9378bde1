"""Duration-constrained composite Viterbi: min / max state durations.

The port of the JAX package's ops/viterbi_duration.py: the composite
trellis composed with per-state duration counters,

  alpha[s, d] = best score of paths in state s for (d + 1) consecutive
                frames (d saturates at the cap D - 1)

  stay     alpha'[s, d+1]  <- alpha[s, d] + log_a[s, s]      while d+2 <= max_dur[s]
  advance  alpha'[s2, 0]   <- max_{d+1 >= min_dur[s]} alpha[s, d] + M[s, s2]
  finish   score = max over exit states s, d+1 >= min_dur[s]

M is the composite transition rule without its diagonal. min_dur = 1 and an
unbounded max_dur reproduce the unconstrained dense decode. Backpointers
pack (state, duration) into one int32 (the kernel's team branch: one byte
a cell); every argmax is a first max. On a
CUDA log_b the lattice is one launch of the DURATION kernel
(ops/cuda/trellis_constrained.duration_decode), which walks its own path
(past its team branches: and one of K2-bt); its plain version,
viterbi_composite_duration_batch_plain, advances a batch (B, S, D) by a
Python loop over T, for the CPU and the tests.

A repeated single-state word (exit == entry) cannot be expressed and is
rejected by duration_arrays.
"""
from __future__ import annotations

import numpy as np
import torch

# UNBOUNDED, the max_dur sentinel (no upper duration limit), is the kernel's.
from .cuda.trellis_constrained import UNBOUNDED, duration_decode
from .viterbi import NEG, composite_transition_matrix
from .viterbi_counted import _topology, packed_backtrace


def viterbi_composite_duration_batch(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty,
    min_dur, max_dur, lengths, d_cap: int = 8, quirk_backtrace: bool = True,
):
    """log_b (B, T, S) float32, min_dur / max_dur (S,) int (max_dur may be
    UNBOUNDED), lengths (B,) -> (scores (B,), paths (B, T) int32). d_cap
    must exceed every finite max_dur and be >= every min_dur
    (duration_arrays). A CUDA log_b runs the DURATION kernel, bitwise the
    plain version in scores and in the paths of every row with a finite
    score (ROADMAP W3); a CPU log_b the plain version."""
    if not log_b.is_cuda:
        return viterbi_composite_duration_batch_plain(
            log_b, log_a, lower_of_state, is_entry, is_exit, penalty, min_dur, max_dur,
            lengths, d_cap, quirk_backtrace)
    return duration_decode(log_b, log_a, lower_of_state, is_entry, is_exit, penalty,
                           min_dur, max_dur, lengths, d_cap, quirk_backtrace)


def viterbi_composite_duration_batch_plain(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty,
    min_dur, max_dur, lengths, d_cap: int = 8, quirk_backtrace: bool = True,
):
    """viterbi_composite_duration_batch's plain version, on log_b's
    device: the (B, S, D) lattice advanced by a Python loop over T."""
    b, t_total, s = log_b.shape
    dev = log_b.device
    d = d_cap
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    log_a, entry, exit_, diag_init = _topology(log_b, log_a, is_entry, is_exit)
    m_adv = composite_transition_matrix(log_a, lower_of_state, entry, exit_, penalty,
                                        device=dev)
    m_adv = torch.where(torch.eye(s, dtype=torch.bool, device=dev), NEG, m_adv)
    diag = torch.diagonal(log_a)
    min_dur = torch.as_tensor(np.asarray(min_dur), device=dev).to(torch.int64)
    max_dur = torch.as_tensor(np.asarray(max_dur), device=dev).to(torch.int64)

    durs = torch.arange(d, device=dev)
    complete = (durs[None, :] + 1) >= min_dur[:, None]        # (S, D)
    stay_ok = (durs[None, :] + 1) <= max_dur[:, None]         # (S, D)
    unbounded = max_dur >= int(UNBOUNDED)                     # (S,)
    states = torch.arange(s, device=dev)
    stay_bp = (states[:, None] * d + (durs[None, :] - 1).clamp(min=0)).expand(b, s, d).clone()

    alpha = torch.full((b, s, d), NEG, device=dev)
    alpha[:, :, 0] = torch.where(entry, log_b[:, 0] + diag_init, NEG)
    neg_col = torch.full((b, s, 1), NEG, device=dev)
    bps = torch.empty((b, t_total, s * d), dtype=torch.int32, device=dev)
    bps[:, 0] = -1
    for t in range(1, t_total):
        # Advance: the best completed visit of each source state.
        best_comp, best_comp_d = torch.where(complete, alpha, NEG).max(dim=2)  # (B, S)
        adv_val, adv_src = torch.max(best_comp[:, :, None] + m_adv, dim=1)      # (B, S)
        adv_bp = adv_src * d + best_comp_d.gather(1, adv_src)
        # Stay: shift along the duration axis, saturating at D - 1 when unbounded.
        shifted = torch.cat([neg_col, alpha[:, :, :-1]], dim=2)
        sat = torch.where(unbounded, alpha[:, :, d - 1], NEG)
        stay_shift = shifted.clone()
        stay_shift[:, :, d - 1] = torch.maximum(shifted[:, :, d - 1], sat)
        stay_val = torch.where(stay_ok, stay_shift + diag[:, None], NEG)
        from_sat = unbounded & (alpha[:, :, d - 1] > shifted[:, :, d - 1])
        stay_bp[:, :, d - 1] = torch.where(from_sat, states * d + (d - 1), states * d + (d - 2))
        # Column 0 is advance-only, columns > 0 stay-only.
        stay_val[:, :, 0] = adv_val
        stay_bp[:, :, 0] = adv_bp
        bps[:, t] = stay_bp.reshape(b, -1).to(torch.int32)
        new_alpha = stay_val + log_b[:, t, :, None]
        alpha = torch.where((t < lengths)[:, None, None], new_alpha, alpha)

    final = torch.where(exit_[:, None] & complete, alpha, NEG).reshape(b, -1)
    scores, best_cell = final.max(dim=1)
    paths = packed_backtrace(bps, best_cell, lengths, quirk_backtrace) // d
    return scores, paths.to(torch.int32)


def viterbi_composite_duration(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, min_dur, max_dur,
    length=None, d_cap: int = 8, quirk_backtrace: bool = True,
):
    """One utterance: log_b (T, S) -> (score, path (T,) int32) of
    viterbi_composite_duration_batch on a batch of one."""
    length = log_b.shape[0] if length is None else int(length)
    scores, paths = viterbi_composite_duration_batch(
        log_b[None], log_a, lower_of_state, is_entry, is_exit, penalty, min_dur, max_dur,
        [length], d_cap, quirk_backtrace)
    return scores[0], paths[0]


def duration_arrays(composite, min_duration, max_duration=None,
                    constrain_silence: bool = False):
    """Per-state (min_dur, max_dur, d_cap) from scalar-or-dict knobs.

    min_duration / max_duration: an int for every state of every word, or
    {label: int} per word. Silence states stay unconstrained unless
    constrain_silence. Rejects single-state words and returns the smallest
    static d_cap."""
    s = composite.num_states
    min_dur = np.ones(s, np.int32)
    max_dur = np.full(s, UNBOUNDED, np.int32)

    def per_label(knob, label, default):
        if knob is None:
            return default
        if isinstance(knob, dict):
            return int(knob.get(label, default))
        return int(knob)

    single = [
        l for l, n in zip(composite.labels, composite.state_counts) if n == 1
    ]
    if single:
        raise ValueError(
            f"single-state words {single} cannot use the duration decoder: "
            "their repeat (exit == entry) is a diagonal move the duration "
            "lattice reads as a stay (module caveat)"
        )
    for w, label in enumerate(composite.labels):
        if label == "S" and not constrain_silence:
            continue
        lo, hi = int(composite.lowers[w]), int(composite.uppers[w]) + 1
        min_dur[lo:hi] = per_label(min_duration, label, 1)
        max_dur[lo:hi] = per_label(max_duration, label, UNBOUNDED)
    if (min_dur < 1).any():
        raise ValueError("min durations must be >= 1")
    if (max_dur < min_dur).any():
        raise ValueError("max_duration below min_duration")
    finite = max_dur[max_dur < UNBOUNDED]
    d_cap = int(max(
        int(min_dur.max()),
        int(finite.max()) if finite.size else 1,
        2,
    ))
    return min_dur, max_dur, d_cap
