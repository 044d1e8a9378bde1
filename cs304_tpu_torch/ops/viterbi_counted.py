"""Word-count-constrained composite Viterbi.

The port of the JAX package's ops/viterbi_counted.py: the composite trellis
composed with a word counter, decoding the best path that emits exactly N
counted words (silence is free). The trellis state is (N + 1, S), count
plane x composite state, and a step is

  stay (same plane):   banded within-word moves + entry self-loops
  cross (plane c-1 -> c for counted words, c -> c for silence):
                       word exit -> word entry + penalty

Termination takes the best word exit in plane N. Backpointers pack
(plane, state) into one int32. Entry seeding, the exits-over-self-loop tie
order and the backtrace quirk follow ops/viterbi.py; every argmax is a
first max (torch's max over a dim), as jnp.argmax.

Counted decoding is grammar decoding under the chain automaton
(chain_grammar): on a CUDA log_b it is one launch of the PLANES kernel
(ops/cuda/trellis_constrained.planes_decode), which walks its own path
(past its team branches: and one of K2-bt). Its plain version,
viterbi_composite_counted_batch_plain, advances the batch as one tensor
(B, N + 1, S) by a Python loop over T; the CPU and the tests run it.
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda.trellis_constrained import planes_decode
from .viterbi import NEG, backtrace_batch


def _stay_matrix(log_a, lower_of_state, is_entry, skip: int = 2, device=None):
    """(S, S) log transitions that do not end a word: the banded within-word
    moves (band floor at the word's entry state) plus each entry state's
    self-loop."""
    log_a = torch.as_tensor(log_a, dtype=torch.float32, device=device)
    dev = log_a.device
    lower = torch.as_tensor(lower_of_state, device=dev).to(torch.int64)
    entry = torch.as_tensor(is_entry, device=dev).to(torch.bool)
    s = log_a.shape[0]
    frm = torch.arange(s, device=dev)[:, None]
    to = torch.arange(s, device=dev)[None, :]
    band = (frm <= to) & (frm >= torch.maximum(to - skip, lower[None, :]))
    m = torch.where(band & ~entry[None, :], log_a, NEG)
    return torch.where((frm == to) & entry[None, :], log_a, m)


def _topology(log_b, log_a, is_entry, is_exit):
    """log_a, masks and the degenerate-safe t = 0 self-loops on log_b's
    device."""
    dev = log_b.device
    log_a = torch.as_tensor(log_a, dtype=torch.float32, device=dev)
    entry = torch.as_tensor(is_entry, device=dev).to(torch.bool)
    exit_ = torch.as_tensor(is_exit, device=dev).to(torch.bool)
    diag = torch.diagonal(log_a)
    diag_init = torch.where(torch.isfinite(diag), diag, torch.zeros_like(diag))
    return log_a, entry, exit_, diag_init


def packed_backtrace(bps, start, lengths, quirk: bool):
    """Walk packed backpointers (B, T, cells) from the packed start cells
    (B,) -> packed cell paths (B, T) int64 (backtrace_batch's walk; the
    quirk copies whole cells, as it copies the states they hold)."""
    return backtrace_batch(bps, start.to(torch.int32), lengths, quirk).to(torch.int64)


def chain_grammar(counted_word_of_state, n_words: int, n_words_min: int | None = None):
    """The word counter as a word automaton over two word classes (0:
    silence and every uncounted word, 1: a counted word) -> (word_of_state
    (S,) int32, next_state (N + 1, 2) int32, accept (N + 1,) bool): a
    counted word moves plane c to c + 1 (none past N), the others keep the
    plane; planes n_words_min (default n_words) .. n_words accept."""
    if isinstance(counted_word_of_state, torch.Tensor):
        counted_word_of_state = counted_word_of_state.cpu().numpy()
    counted = np.asarray(counted_word_of_state).astype(bool)
    g = n_words + 1
    next_state = np.full((g, 2), -1, np.int32)
    next_state[:, 0] = np.arange(g)
    next_state[:-1, 1] = np.arange(1, g)
    accept = np.zeros(g, bool)
    accept[(n_words if n_words_min is None else n_words_min): g] = True
    return counted.astype(np.int32), next_state, accept


def viterbi_composite_counted_batch(
    log_b, log_a, lower_of_state, is_entry, is_exit, counted_word_of_state,
    penalty, n_words: int, lengths, quirk_backtrace: bool = True,
    n_words_min: int | None = None,
):
    """Best paths emitting exactly n_words counted words (or, with
    n_words_min, between n_words_min and n_words): log_b (B, T, S) float32,
    counted_word_of_state (S,) bool (False for silence), lengths (B,) ->
    (scores (B,), paths (B, T) int32); a score is -inf where no admissible
    path exists in the utterance's frames. A CUDA log_b runs the PLANES
    kernel on chain_grammar's automaton, bitwise the plain version in
    scores and in the paths of every row with a finite score (ROADMAP W3);
    a CPU log_b the plain version."""
    if not log_b.is_cuda:
        return viterbi_composite_counted_batch_plain(
            log_b, log_a, lower_of_state, is_entry, is_exit, counted_word_of_state,
            penalty, n_words, lengths, quirk_backtrace, n_words_min)
    word, next_state, accept = chain_grammar(counted_word_of_state, n_words, n_words_min)
    return planes_decode(log_b, log_a, lower_of_state, is_entry, is_exit, word, next_state,
                         accept, penalty, lengths, quirk_backtrace)


def viterbi_composite_counted_batch_plain(
    log_b, log_a, lower_of_state, is_entry, is_exit, counted_word_of_state,
    penalty, n_words: int, lengths, quirk_backtrace: bool = True,
    n_words_min: int | None = None,
):
    """viterbi_composite_counted_batch's plain version, on log_b's device:
    the (B, N + 1, S) trellis advanced by a Python loop over T."""
    b, t_total, s = log_b.shape
    dev = log_b.device
    c_planes = n_words + 1
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    log_a, entry, exit_, diag_init = _topology(log_b, log_a, is_entry, is_exit)
    stay = _stay_matrix(log_a, lower_of_state, entry)
    penalty = torch.as_tensor(penalty, dtype=torch.float32, device=dev)
    counted = torch.as_tensor(counted_word_of_state, device=dev).to(torch.bool)
    counted_entry = entry & counted

    plane_idx = torch.arange(c_planes, device=dev)[:, None]          # (C, 1)
    seed_plane = torch.where(counted_entry, 1, 0)[None, :]           # (1, S)
    alpha = torch.where(entry[None, :] & (plane_idx == seed_plane),
                        (log_b[:, 0] + diag_init)[:, None, :], NEG)  # (B, C, S)
    src_plane = torch.where(counted_entry[None, :], (plane_idx - 1).clamp(min=0),
                            plane_idx)                               # (C, S)
    stay_plane = plane_idx.expand(c_planes, s)
    neg_col = torch.full((b, 1), NEG, device=dev)
    zero_col = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    bps = torch.empty((b, t_total, c_planes * s), dtype=torch.int32, device=dev)
    bps[:, 0] = -1
    for t in range(1, t_total):
        stay_val, stay_bp = torch.max(alpha[:, :, :, None] + stay, dim=2)
        be, be_idx = torch.where(exit_, alpha, NEG).max(dim=2)        # (B, C)
        # Counted entries read plane c - 1; silence entries read plane c.
        be_prev = torch.cat([neg_col, be[:, :-1]], dim=1)
        be_prev_idx = torch.cat([zero_col, be_idx[:, :-1]], dim=1)
        src_val = torch.where(counted_entry, be_prev[:, :, None], be[:, :, None])
        src_idx = torch.where(counted_entry, be_prev_idx[:, :, None], be_idx[:, :, None])
        cross_val = torch.where(entry, src_val + penalty, NEG)
        # Exits win exact ties against the entry self-loop.
        use_cross = cross_val >= stay_val
        new_alpha = torch.maximum(stay_val, cross_val) + log_b[:, t, None, :]
        bp_state = torch.where(use_cross, src_idx, stay_bp)
        bp_plane = torch.where(use_cross, src_plane, stay_plane)
        bps[:, t] = (bp_plane * s + bp_state).reshape(b, -1).to(torch.int32)
        alpha = torch.where((t < lengths)[:, None, None], new_alpha, alpha)

    lo = n_words if n_words_min is None else n_words_min
    final = torch.where(exit_, alpha[:, lo: n_words + 1], NEG).reshape(b, -1)
    scores, flat = final.max(dim=1)
    start = (flat // s + lo) * s + flat % s
    paths = packed_backtrace(bps, start, lengths, quirk_backtrace) % s
    return scores, paths.to(torch.int32)


def viterbi_composite_counted(
    log_b, log_a, lower_of_state, is_entry, is_exit, counted_word_of_state,
    penalty, n_words: int, length=None, quirk_backtrace: bool = True,
    n_words_min: int | None = None,
):
    """One utterance: log_b (T, S) -> (score, path (T,) int32) of
    viterbi_composite_counted_batch on a batch of one."""
    length = log_b.shape[0] if length is None else int(length)
    scores, paths = viterbi_composite_counted_batch(
        log_b[None], log_a, lower_of_state, is_entry, is_exit, counted_word_of_state,
        penalty, n_words, [length], quirk_backtrace, n_words_min)
    return scores[0], paths[0]
