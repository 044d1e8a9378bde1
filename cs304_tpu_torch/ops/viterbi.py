"""Composite Viterbi over the flattened word-HMM state space, plain PyTorch.

This is the plain version of the scan-free trellis kernels
(ops/cuda/trellis_scanfree.py) and their bitwise specification. The composite
topology gives every state at most three banded predecessors and every word
entry one shared candidate (best word exit + penalty), so a step is O(S):

  non-entry j:  max(alpha[j-2]+A[j-2,j], alpha[j-1]+A[j-1,j], alpha[j]+A[j,j])
  entry e:      max(best_exit + penalty, alpha[e]+A[e,e])

Tie-breaks: skip-2, then skip-1, then self on >=; an exit beats the entry's
self-loop on an exact tie; the lowest exit index wins among exits, and when
every exit is -inf the index is 0. Steps t >= length leave alpha unchanged.

Two search options of the JAX package's banded step (its
viterbi_composite_batch_fast) ride the same recursion:

- a bigram LM (``pair_penalty`` (W, W), ops/lm.word_pair_penalties): the
  entry of word w takes max over v of (best exit of v + pair[v, w]), a
  per-word tropical matvec; the lowest source word wins a tie and an all
  -inf column takes source 0, so its backpointer is uppers[0];
- a beam: after each update every state below (max - beam) is set to -inf,
  before the length mask, and alpha0 is pruned the same way; backpointers
  are those of the unpruned step.

These are the plain versions of the LM and BEAM decode modes and of the LM
stream mode of the scan-free team kernel (ops/cuda/trellis_scanfree.py,
ops/cuda/trellis_stream.py).

Backtrace parity note: the reference's backtrace drops the true final state,
so path[L-1] == path[L-2]; ``quirk_backtrace=True`` (the default) reproduces
that. Backpointers are int32. The time loop is a Python loop.

The dense composite trellis (``viterbi_composite(_batch)``, the decoder's
"scan" backend) runs the same topology as an (S, S) max-plus step
(``composite_transition_matrix``, ``dense_forward``), the plain version of
the dense trellis kernel (ops/cuda/trellis_dense.py). Its argmax is a
first max over all S predecessors: the lowest predecessor index wins a
tie, so an entry's self-loop beats an exit of higher index (the banded
step above lets the exit win), and an all -inf column points at 0.

Two single-topology recursions sit beside it:

- ``viterbi_banded(_batch)``: one left-to-right word HMM (the segmental
  k-means E-step, isolated-word scoring, forced alignment), the dense step
  over the skip-2 band (``viterbi_banded_batch_plain``); on a card the
  sentence kernel on the band's diagonals;
- ``banded_sentence_forward``: the embedded trainer's sentence trellis with
  per-utterance destination-indexed diagonals c0/c1/c2 and no entry/exit
  pool, the plain version of the banded trellis kernel
  (ops/cuda/trellis_banded.py). Its tie order starts from skip-2 and replaces
  only on a strict improvement, so an all -inf column points at max(j-2, 0).
"""
from __future__ import annotations

import torch

NEG = float("-inf")


def pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=None) -> torch.Tensor:
    """The O(S) banded coefficients as an (8, S) float32 tensor, rows:
    diag_ne, sub1, sub2, diag_e, is_entry, is_exit, diag_init, unused.
    sub1/sub2 are the skip-1/-2 transitions with the band floored at the
    word's entry state; diag_init replaces a non-finite self-loop by 0 for
    the t=0 row."""
    log_a = torch.as_tensor(log_a, dtype=torch.float32, device=device)
    dev = log_a.device
    lower = torch.as_tensor(lower_of_state, device=dev).to(torch.int64)
    entry = torch.as_tensor(is_entry, device=dev).to(torch.bool)
    exit_ = torch.as_tensor(is_exit, device=dev).to(torch.bool)
    s = log_a.shape[0]
    to = torch.arange(s, device=dev)
    diag = torch.diagonal(log_a)
    neg = torch.full((s,), NEG, dtype=torch.float32, device=dev)
    sub1 = torch.where(
        (to >= 1) & (to - 1 >= lower) & ~entry,
        log_a[torch.clamp(to - 1, min=0), to], neg,
    )
    sub2 = torch.where(
        (to >= 2) & (to - 2 >= lower) & ~entry,
        log_a[torch.clamp(to - 2, min=0), to], neg,
    )
    return torch.stack([
        torch.where(~entry, diag, neg),
        sub1,
        sub2,
        torch.where(entry, diag, neg),
        entry.to(torch.float32),
        exit_.to(torch.float32),
        torch.where(torch.isfinite(diag), diag, torch.zeros_like(diag)),
        torch.zeros_like(diag),
    ])


def first_max(values: torch.Tensor, mask: torch.Tensor):
    """Masked max over the last axis and the LOWEST index attaining it;
    with every masked value -inf (or nothing masked) the index is 0, as a
    first-max argmax over the full (-inf-filled) row gives."""
    masked = torch.where(mask, values, torch.full_like(values, NEG))
    best = masked.max(dim=-1, keepdim=True).values
    lanes = torch.arange(values.shape[-1], device=values.device)
    idx = torch.where(masked == best, lanes, values.shape[-1]).min(dim=-1).values
    return best.squeeze(-1), idx.to(torch.int32)


def lm_tables(pair_penalty, word_of_state, uppers, device=None):
    """A bigram LM's operands on one device, as the kernels take them:
    (pair (W, W) float32, word_of_state (S,) int32, uppers (W,) int32)."""
    return (torch.as_tensor(pair_penalty, dtype=torch.float32, device=device).contiguous(),
            torch.as_tensor(word_of_state, device=device).to(torch.int32).contiguous(),
            torch.as_tensor(uppers, device=device).to(torch.int32).contiguous())


def entry_update(alpha, is_exit, penalty, pair_penalty=None,
                 word_of_state=None, uppers=None):
    """Word-entry predecessor candidates: alpha (B, S) -> (c_pen,
    best_exit_idx int64). Flat penalty: (B, 1) each, the best exit +
    penalty and its first-max index (int64). pair_penalty (W, W) with word_of_state
    (S,) and uppers (W,) (lm_tables): (B, S) each, the per-word tropical
    matvec max over v of (alpha[uppers[v]] + pair[v, w(s)]) and
    uppers[first v attaining it] (in uppers' dtype; torch's max over a dim
    keeps the first index and its own value)."""
    if pair_penalty is not None:
        cand = alpha[:, uppers][:, :, None] + pair_penalty[None]  # (B, W, W)
        best_w, src_w = cand.max(dim=1)                            # (B, W)
        return best_w[:, word_of_state], uppers[src_w[:, word_of_state]]
    best, idx = first_max(alpha, is_exit)
    return (best + penalty)[:, None], idx[:, None].to(torch.int64)


def prune(alpha, beam):
    """The beam: states below (row max - beam) set to -inf. beam a float32
    scalar tensor on alpha's device."""
    thresh = alpha.max(dim=1, keepdim=True).values - beam
    return torch.where(alpha >= thresh, alpha, NEG)


def forward_fast(log_b, coefs, penalty, lengths, lm=None, beam=None):
    """Forward recursion. log_b (B, T, >=S) float32 (columns past S are
    ignored), coefs (8, S) from pack_coefs, lengths (B,) ->
    (alpha (B, S) float32, backpointers (B, T, S) int32 with row 0 = -1).
    lm: lm_tables' (pair, word_of_state, uppers) for a bigram LM (penalty
    then unused); beam: the per-step prune (module docstring)."""
    b, t_total = log_b.shape[:2]
    s = coefs.shape[1]
    dev = log_b.device
    diag_ne, sub1, sub2, diag_e = coefs[0], coefs[1], coefs[2], coefs[3]
    entry, exit_ = coefs[4] > 0, coefs[5] > 0
    to = torch.arange(s, device=dev, dtype=torch.int32)
    to1 = torch.clamp(to - 1, min=0)
    to2 = torch.clamp(to - 2, min=0)
    penalty = torch.as_tensor(penalty, dtype=torch.float32, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)

    if beam is not None:
        beam = torch.as_tensor(beam, dtype=torch.float32, device=dev)
    alpha = torch.where(entry, log_b[:, 0, :s] + coefs[6], NEG)
    if beam is not None:
        alpha = prune(alpha, beam)
    bps = torch.empty((b, t_total, s), dtype=torch.int32, device=dev)
    bps[:, 0] = -1
    for t in range(1, t_total):
        a1 = torch.full_like(alpha, NEG)
        a1[:, 1:] = alpha[:, :-1]
        a2 = torch.full_like(alpha, NEG)
        a2[:, 2:] = alpha[:, :-2]
        c0 = alpha + diag_ne
        c1 = a1 + sub1
        c2 = a2 + sub2
        v12 = torch.maximum(c1, c0)
        val_ne = torch.maximum(c2, v12)
        bp_ne = torch.where(c2 >= v12, to2, torch.where(c1 >= c0, to1, to))

        c_pen, best_exit_idx = entry_update(alpha, exit_, penalty, *(lm or ()))
        c_self = alpha + diag_e
        val_e = torch.maximum(c_pen, c_self)
        bp_e = torch.where(c_pen >= c_self, best_exit_idx.to(torch.int32), to)

        new_alpha = torch.where(entry, val_e, val_ne) + log_b[:, t, :s]
        if beam is not None:
            new_alpha = prune(new_alpha, beam)
        bps[:, t] = torch.where(entry, bp_e, bp_ne)
        live = (t < lengths)[:, None]
        alpha = torch.where(live, new_alpha, alpha)
    return alpha, bps


def backtrace_batch(backptrs, best, lengths, quirk: bool = True):
    """Reverse walk: backptrs (B, T, S) int32, best (B,) start states,
    lengths (B,) -> paths (B, T) int32. path[t] is the state held when
    stepping back from t (emitted before stepping), so entries at
    t >= length hold the start state; path[0] is the final state."""
    b, t_total, _ = backptrs.shape
    dev = backptrs.device
    lengths = torch.as_tensor(lengths, device=dev)
    state = best.to(torch.int64)
    path = torch.empty((b, t_total), dtype=torch.int32, device=dev)
    for t in range(t_total - 1, 0, -1):
        path[:, t] = state.to(torch.int32)
        nxt = backptrs[:, t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = torch.where(t <= lengths - 1, nxt, state)
    path[:, 0] = state.to(torch.int32)
    if quirk:
        path = apply_quirk(path, lengths)
    return path


def apply_quirk(paths, lengths):
    """path[len-1] = path[len-2] per row (indices clamped at 0; a length past
    T writes nothing)."""
    t_total = paths.shape[1]
    lengths = torch.as_tensor(lengths, device=paths.device).to(torch.int64)
    last = torch.clamp(lengths - 1, min=0)
    second = torch.clamp(lengths - 2, min=0, max=t_total - 1)
    rows = torch.nonzero(last < t_total)[:, 0]
    out = paths.clone()
    out[rows, last[rows]] = paths[rows, second[rows]]
    return out


def backpointer_codes(backptrs, coefs, lengths, per_word: bool = False):
    """The decode-mode kernel's one-byte backpointers, plain: backptrs
    (B, T, S) int32 from forward_fast, coefs (8, S), lengths (B,) ->
    (codes (B, T, S) uint8, best_exit (B, T) int16). At every live step
    1 <= t < min(length, T) a non-entry state's code c in {0, 1, 2} means
    max(j - c, 0); an entry state's is 0 (itself) or 3, the step's one
    best-exit index best_exit[b, t]. Other rows are 0. Raises ValueError
    where a backpointer breaks that scheme. per_word=True is the LM decode
    mode's layout: best_exit (B, T, W), the source state of word w's entry
    at step t (the kernel stores it for every word; here 0 where the entry
    did not take an exit)."""
    b, t_total, s = backptrs.shape
    dev = backptrs.device
    j = torch.arange(s, device=dev, dtype=torch.int64)
    entry = coefs[4].to(dev) > 0
    bp = backptrs.to(torch.int64)
    t_idx = torch.arange(t_total, device=dev)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    live = ((t_idx >= 1)[None, :] & (t_idx[None, :] < lengths[:, None]))[..., None]
    step = j - bp
    takes_exit = entry & (bp != j)
    band_ok = (step >= 0) & (step <= 2) & (bp == torch.clamp(j - step, min=0))
    codes = torch.where(takes_exit, 3, torch.where(entry, 0, step))
    codes = torch.where(live, codes, 0).to(torch.uint8)
    if per_word:
        # One entry state a word: each word's source is its own entry's.
        ok = torch.where(entry, True, band_ok)
        best_exit = torch.where(takes_exit & live, bp, 0)[..., torch.nonzero(entry)[:, 0]]
    else:
        # Every entry that took an exit at a step names the same state.
        first = torch.where(takes_exit, bp, s).min(dim=-1).values
        last = torch.where(takes_exit, bp, -1).max(dim=-1).values
        ok = torch.where(entry, ~takes_exit | (first == last)[..., None], band_ok)
        best_exit = torch.where(live[..., 0] & (first < s), first, 0)
    if not bool(ok[live.expand_as(ok)].all()):
        raise ValueError("backpointers outside the banded / best-exit scheme")
    return codes, best_exit.to(torch.int16)


def backtrace_codes(codes, best_exit, best, lengths, quirk: bool = True,
                    word_of_state=None):
    """backtrace_batch over backpointer codes: codes (B, T, S) uint8 and
    best_exit (B, T) int16 from backpointer_codes, best (B,) start states,
    lengths (B,) -> paths (B, T) int32, the walk the decode-mode kernel runs
    in shared memory. The LM layout (best_exit (B, T, W)) needs
    word_of_state (S,): code 3 at a state of word w reads best_exit[:, t, w]."""
    b, t_total, _ = codes.shape
    dev = codes.device
    lengths = torch.as_tensor(lengths, device=dev)
    if word_of_state is not None:
        word_of_state = torch.as_tensor(word_of_state, device=dev).to(torch.int64)
    state = best.to(torch.int64)
    path = torch.empty((b, t_total), dtype=torch.int32, device=dev)
    for t in range(t_total - 1, 0, -1):
        path[:, t] = state.to(torch.int32)
        c = codes[:, t].gather(1, state[:, None])[:, 0].to(torch.int64)
        if word_of_state is None:
            src = best_exit[:, t]
        else:
            src = best_exit[:, t].gather(1, word_of_state[state][:, None])[:, 0]
        nxt = torch.where(c == 3, src.to(torch.int64), torch.clamp(state - c, min=0))
        state = torch.where(t <= lengths - 1, nxt, state)
    path[:, 0] = state.to(torch.int32)
    if quirk:
        path = apply_quirk(path, lengths)
    return path


def _backtrace(backptrs, best_state, length, quirk: bool = True):
    """One utterance: backptrs (T, S), best_state scalar, length scalar ->
    path (T,) int32."""
    best = torch.as_tensor(best_state, device=backptrs.device).reshape(1)
    length = torch.as_tensor(length, device=backptrs.device).reshape(1)
    return backtrace_batch(backptrs[None], best, length, quirk)[0]


def viterbi_composite_batch_fast(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool = True, pair_penalty=None, word_of_state=None,
    uppers=None, beam=None,
):
    """Composite batch decode: log_b (B, T, S) float32, lengths (B,) ->
    (scores (B,) float32, paths (B, T) int32), on log_b's device.
    pair_penalty (W, W) with word_of_state (S,) and uppers (W,): a bigram
    LM's per-pair entry update; beam: the per-step prune (module
    docstring). The plain version of the LM / BEAM decode modes."""
    dev = log_b.device
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    lm = (lm_tables(pair_penalty, word_of_state, uppers, device=dev)
          if pair_penalty is not None else None)
    alpha, bps = forward_fast(log_b, coefs, penalty, lengths, lm=lm, beam=beam)
    scores, best = first_max(alpha, coefs[5] > 0)
    return scores, backtrace_batch(bps, best, lengths, quirk_backtrace)


def banded_transition_matrix(log_a) -> torch.Tensor:
    """Mask (..., S, S) log transitions to the left-to-right skip-2 band
    s - 2 <= s' <= s (reference hidden_markov_model.py:181)."""
    log_a = torch.as_tensor(log_a, dtype=torch.float32)
    s = log_a.shape[-1]
    frm = torch.arange(s, device=log_a.device)[:, None]
    to = torch.arange(s, device=log_a.device)[None, :]
    allowed = (frm <= to) & (frm >= to - 2)
    return torch.where(allowed, log_a, torch.full_like(log_a, NEG))


def composite_transition_matrix(log_a, lower_of_state, is_entry, is_exit,
                                penalty, skip: int = 2, device=None) -> torch.Tensor:
    """The (S, S) effective transition matrix of the flattened word-HMM
    state space. Word-internal column s: log_a[s', s] for
    max(s - skip, lower(s)) <= s' <= s; word-entry column e: the penalty
    from every exit state, and the self-loop log_a[e, e] (a single-state
    word, both entry and exit, takes the larger of the two)."""
    log_a = torch.as_tensor(log_a, dtype=torch.float32, device=device)
    dev = log_a.device
    lower = torch.as_tensor(lower_of_state, device=dev).to(torch.int64)
    entry = torch.as_tensor(is_entry, device=dev).to(torch.bool)
    exit_ = torch.as_tensor(is_exit, device=dev).to(torch.bool)
    s = log_a.shape[0]
    frm = torch.arange(s, device=dev)[:, None]
    to = torch.arange(s, device=dev)[None, :]
    band = (frm <= to) & (frm >= torch.maximum(to - skip, lower[None, :]))
    neg = torch.full_like(log_a, NEG)
    penalty = torch.as_tensor(penalty, dtype=torch.float32, device=dev)
    m_entry = torch.where(exit_[:, None], penalty, neg)
    m_entry = torch.maximum(m_entry, torch.where(frm == to, log_a, neg))
    return torch.where(entry[None, :], m_entry, torch.where(band, log_a, neg))


def dense_forward(log_b, trans, alpha0, lengths):
    """Dense max-plus forward recursion. log_b (B, T, >=S) float32 (columns
    past S = trans.shape[-1] are ignored), trans (S, S) or (B, S, S),
    alpha0 (B, S), lengths (B,) -> (alpha (B, S), backpointers (B, T, S)
    int32 with row 0 = -1). The argmax is torch's first max over the S
    predecessors; steps t >= length keep alpha but still write
    backpointers. The plain version of the dense trellis kernel."""
    b, t_total = log_b.shape[:2]
    s = trans.shape[-1]
    lengths = torch.as_tensor(lengths, device=log_b.device)
    alpha = alpha0
    bps = torch.empty((b, t_total, s), dtype=torch.int32, device=log_b.device)
    bps[:, 0] = -1
    for t in range(1, t_total):
        best, arg = torch.max(alpha[:, :, None] + trans, dim=1)
        bps[:, t] = arg.to(torch.int32)
        alpha = torch.where((t < lengths)[:, None], best + log_b[:, t, :s], alpha)
    return alpha, bps


def dense_decode(log_b, trans, coefs, lengths, quirk_backtrace: bool = True,
                 forward=dense_forward, backtrace=backtrace_batch):
    """Composite decode on a dense transition matrix: every entry state
    seeded with its t=0 emission and degenerate-safe self-loop (coefs from
    pack_coefs), the forward recursion, the best exit (first max), the
    backtrace. log_b (B, T, >=S), lengths (B,) int32 -> (scores (B,),
    paths (B, T) int32)."""
    s = trans.shape[-1]
    alpha0 = torch.where(coefs[4] > 0, log_b[:, 0, :s] + coefs[6], NEG)
    alpha, bps = forward(log_b, trans, alpha0, lengths)
    scores, best = first_max(alpha, coefs[5] > 0)
    return scores, backtrace(bps, best, lengths, quirk_backtrace)


def viterbi_composite_batch(
    log_b, log_a, lower_of_state, is_entry, is_exit, penalty, lengths,
    quirk_backtrace: bool = True,
):
    """Dense composite batch decode (the "scan" backend): log_b (B, T, S)
    float32, lengths (B,) -> (scores (B,) float32, paths (B, T) int32).
    Scores equal viterbi_composite_batch_fast's; paths differ only where an
    entry's self-loop ties an exit of higher index exactly."""
    dev = log_b.device
    trans = composite_transition_matrix(log_a, lower_of_state, is_entry,
                                        is_exit, penalty, device=dev)
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return dense_decode(log_b, trans, coefs, lengths, quirk_backtrace)


def viterbi_composite(log_b, log_a, lower_of_state, is_entry, is_exit, penalty,
                      length=None, quirk_backtrace: bool = True):
    """One utterance: log_b (T, S) -> (score, path (T,) int32)."""
    if length is None:
        length = log_b.shape[0]
    lengths = torch.as_tensor([int(length)], dtype=torch.int32, device=log_b.device)
    score, paths = viterbi_composite_batch(
        log_b[None], log_a, lower_of_state, is_entry, is_exit, penalty,
        lengths, quirk_backtrace)
    return score[0], paths[0]


def banded_diagonals(log_a, batch: int):
    """The destination-indexed diagonals of banded_transition_matrix(log_a)
    as contiguous (B, S) float32 rows (c0[j] = A[j, j], c1[j] = A[j-1, j],
    c2[j] = A[j-2, j]; -inf where j - 1 or j - 2 falls off the band), from
    a shared (S, S) log_a or a per-row (B, S, S) one: the sentence
    kernel's c0 / c1 / c2 (ops/cuda/trellis_banded.py)."""
    log_a = torch.as_tensor(log_a, dtype=torch.float32)
    s = log_a.shape[-1]
    log_a = log_a.expand(batch, s, s)
    neg = torch.full((batch, s), NEG, dtype=torch.float32, device=log_a.device)
    c0 = torch.diagonal(log_a, dim1=1, dim2=2).contiguous()
    c1, c2 = neg, neg.clone()
    c1[:, 1:] = torch.diagonal(log_a, offset=1, dim1=1, dim2=2)
    c2[:, 2:] = torch.diagonal(log_a, offset=2, dim1=1, dim2=2)
    return c0, c1, c2


def viterbi_banded_batch(log_b, log_a, lengths, quirk_backtrace: bool = True):
    """Single left-to-right word HMM Viterbi over a padded batch.

    log_b (B, T, S) float32, log_a (S, S) shared or (B, S, S) per row,
    lengths (B,) -> (scores (B,) = alpha at state S-1, paths (B, T) int32).
    Entry is pinned to state 0 and t=0 includes the entry self-loop
    (hidden_markov_model.py:81-83); a zero-probability self-loop counts as
    log 1 there (the degenerate-safe init).

    A CUDA log_b runs the sentence kernel (ops/cuda/trellis_banded.py) on
    banded_diagonals(log_a) with final state S-1: ONE launch of its decode
    mode with the quirk, or its backpointer mode and K2-bt without it. A
    CPU log_b runs viterbi_banded_batch_plain, which the kernel is bitwise
    in scores and in the paths of every row with a finite score. A row
    whose score is -inf may differ in its path: at a cell every
    predecessor of which is -inf the plain version points at state 0 and
    the kernel at max(j - 2, 0) (ROADMAP W3)."""
    if not log_b.is_cuda:
        return viterbi_banded_batch_plain(log_b, log_a, lengths, quirk_backtrace)
    from .cuda import trellis_banded as tb
    from .cuda.trellis_scanfree import trellis_backtrace

    dev = log_b.device
    b, _t, s = log_b.shape
    log_b = log_b.to(torch.float32).contiguous()
    c0, c1, c2 = banded_diagonals(torch.as_tensor(log_a, device=dev), b)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32).contiguous()
    final = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    if quirk_backtrace:
        return tb.banded_decode(log_b, c0, c1, c2, lengths, final)
    alpha, bp = tb.banded_forward(log_b, c0, c1, c2, lengths)
    return alpha[:, s - 1], trellis_backtrace(bp, final, lengths, quirk=False)


def viterbi_banded_batch_plain(log_b, log_a, lengths, quirk_backtrace: bool = True):
    """viterbi_banded_batch's plain version, on any device: each step is
    dense_forward's max-plus product over banded_transition_matrix(log_a),
    then backtrace_batch from state S-1."""
    dev = log_b.device
    b, t_total, s = log_b.shape
    log_a = torch.as_tensor(log_a, dtype=torch.float32, device=dev)
    trans = banded_transition_matrix(log_a).expand(b, s, s)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    a00 = trans[:, 0, 0]
    a00 = torch.where(torch.isfinite(a00), a00, torch.zeros_like(a00))
    alpha = torch.full((b, s), NEG, dtype=torch.float32, device=dev)
    alpha[:, 0] = log_b[:, 0, 0] + a00
    alpha, bps = dense_forward(log_b, trans, alpha, lengths)
    final = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    return alpha[:, s - 1], backtrace_batch(bps, final, lengths, quirk_backtrace)


def viterbi_banded(log_b, log_a, length=None, quirk_backtrace: bool = True):
    """One utterance: log_b (T, S), log_a (S, S) -> (score, path (T,))."""
    if length is None:
        length = log_b.shape[0]
    lengths = torch.as_tensor([int(length)], dtype=torch.int32, device=log_b.device)
    score, paths = viterbi_banded_batch(log_b[None], log_a, lengths, quirk_backtrace)
    return score[0], paths[0]


def banded_sentence_forward(log_b, c0, c1, c2, lengths, seed=None):
    """Sentence trellis forward: log_b (B, T, S) float32, destination-indexed
    self/prev/skip coefficients c0, c1, c2 (B, S), lengths (B,), seed (B,)
    or None -> (alpha (B, S), backpointers (B, T, S) int32 with row 0 = -1).
    t = 0 holds state 0 alone: log_b[:, 0, 0] + seed where a seed is given,
    else + c0[:, 0] (0 where that is not finite).
    Candidates start from skip-2 and are replaced only on a strict >, so
    ties keep the smallest predecessor. Steps t >= length leave alpha
    unchanged but still write backpointers."""
    b, t_total, s = log_b.shape
    dev = log_b.device
    idx = torch.arange(s, device=dev, dtype=torch.int32)
    idx1 = torch.clamp(idx - 1, min=0).expand(b, s)
    idx2 = torch.clamp(idx - 2, min=0).expand(b, s)
    idx0 = idx.expand(b, s)
    lengths = torch.as_tensor(lengths, device=dev)
    # t = 0: state 0 only, with the seed or its self-loop (0 where that is
    # not finite: the degenerate-safe init).
    if seed is None:
        a00 = torch.where(torch.isfinite(c0[:, 0]), c0[:, 0], torch.zeros_like(c0[:, 0]))
    else:
        a00 = torch.as_tensor(seed, dtype=torch.float32, device=dev)
    alpha = torch.full((b, s), NEG, dtype=torch.float32, device=dev)
    alpha[:, 0] = log_b[:, 0, 0] + a00
    bps = torch.empty((b, t_total, s), dtype=torch.int32, device=dev)
    bps[:, 0] = -1
    neg1 = torch.full((b, 1), NEG, dtype=torch.float32, device=dev)
    neg2 = torch.full((b, min(2, s)), NEG, dtype=torch.float32, device=dev)
    for t in range(1, t_total):
        a1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg2, alpha[:, :-2]], dim=1)
        best = a2 + c2
        bp = idx2
        cand = a1 + c1
        take = cand > best
        best = torch.where(take, cand, best)
        bp = torch.where(take, idx1, bp)
        cand = alpha + c0
        take = cand > best
        best = torch.where(take, cand, best)
        bps[:, t] = torch.where(take, idx0, bp)
        alpha = torch.where((t < lengths)[:, None], best + log_b[:, t], alpha)
    return alpha, bps
