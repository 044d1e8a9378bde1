"""The posterior and n-best searches of the composite decoder: wrappers of
their CUDA kernels (csrc/trellis_lattice.cu), their plain PyTorch versions
and the composite's topology table they share.

- LSUM, ``lattice_sum_passes``: the length-masked sum-semiring forward and
  backward over the composite's (S, S) transition matrix (alphas, beta_em,
  beta_entry, log Z), behind word confidences, occupancy and word-end
  posteriors and consensus decoding. Replaces the lax.scans of
  cs304_tpu/ops/lattice.py:312 ``_sum_passes_masked`` (vmapped by :361
  ``_sum_passes_batch``).
- LMAX, ``lattice_max_passes``: the max-plus forward with the first-max
  argmax and the word-entry-time carry, and the max-plus backward, behind
  ``forward_lattice`` and ``spot_keyword``. Replaces the lax.scans of
  cs304_tpu/ops/lattice.py:227 ``_lattice_passes_impl``.
- KBEST, ``kbest_forward``: K hypotheses a state, the banded merge and the
  shared top K of the exit pool with the duplicate-prefix rule of
  single-state words. Replaces the lax.scan of cs304_tpu/ops/nbest.py:27
  ``kbest_composite_forward``.

The composite enters as a ``LatticeTopology`` (``lattice_topology``): the
O(S) band coefficients of ``ops/viterbi.pack_coefs``, the exit and entry
lists and the per-state ordinals, words and word bounds, uploaded once and
cached by the caller (ops/lattice.topology_of). The penalty is an argument
of each call.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The kernels take 1 <= S <= MAX_LATTICE_STATES and any
B, T >= 1 and K >= 1. LMAX and KBEST are bitwise their plain versions;
LSUM's sums run in the order stated in ``lattice_sum_passes_plain`` and on
the card differ from it only by expf / logf rounding. LSUM, LMAX and KBEST
each have a team branch and, where it does not apply, the first design (the
simple branch); ``lattice_sum_plan`` / ``lattice_max_plan`` / ``kbest_plan``
say which a shape takes, and ``simple=True`` forces the first design
(timing, tests).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .trellis_fb import shift_states
from .trellis_scanfree import _check_cuda

MAX_LATTICE_STATES = 8192  # csrc/trellis_lattice.cu: 1024 threads, 8 states a thread
# LSUM sums a pool of up to this many members (one warp's lanes) in the
# dense matrix's order; past it the pool is factorized. The kernel's own
# value (cs304_lattice_dense_pool_max) is checked against it before a launch.
DENSE_POOL_MAX = 32
NEG = float("-inf")

__all__ = ["DENSE_POOL_MAX", "MAX_LATTICE_STATES", "LatticeTopology", "kbest_forward",
           "kbest_forward_plain", "kbest_plan", "lattice_max_passes", "lattice_max_passes_plain",
           "lattice_max_plan", "lattice_sum_passes", "lattice_sum_passes_plain",
           "lattice_sum_plan", "lattice_topology", "top_k", "topology_of"]


@dataclass(frozen=True)
class LatticeTopology:
    """A composite's search topology on one device.

    coefs (8, S) float32: pack_coefs' rows diag_ne, sub1, sub2, diag_e,
    is_entry, is_exit, diag_init, unused. ints (4, S) int32: each state's
    word, its word's entry state, its word's exit state and its carry bits
    (``carry_bits``). exits / entries: the ascending state lists."""

    coefs: torch.Tensor
    ints: torch.Tensor
    exits: torch.Tensor
    entries: torch.Tensor

    @property
    def num_states(self) -> int:
        return self.coefs.shape[1]

    @property
    def device(self):
        return self.coefs.device


def _host(x, dtype):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


# A state's carry bits (ints row 3): JAX's new-instance rule for each band
# predecessor its forward step can pick (csrc/trellis_lattice.cu NEW_*).
NEW_SUB2, NEW_SUB1, NEW_FROM0 = 1, 2, 4


def new_instance(p, j, word, lower, upper):
    """JAX's new-instance rule (cs304_tpu/ops/lattice.py:263-266): the
    forward's pick p of state j starts a new word instance where p lies in
    another word, or on an exit -> entry re-entry of the same word."""
    return (p != j) & ((word[p] != word[j]) | ((p == upper[j]) & (j == lower[j])))


def carry_bits(word, lower, upper, is_entry, is_exit) -> np.ndarray:
    """(S,) int32: for each state, new_instance of each band predecessor
    its forward step can pick, as bits: NEW_SUB2 j-2 and NEW_SUB1 j-1 (a
    non-entry's band), NEW_FROM0 state 0 (an all -inf column picks the
    first index). LMAX's team branch takes the entry time t or the pick's
    own from them, with no load at the pick. An entry's pool pick (any exit
    but the entry itself) always starts a new instance: a topology where
    it would not (an entry that is not its word's first state, or an exit
    that is not its word's last) raises ValueError."""
    word, lower, upper = (np.asarray(x, np.int64) for x in (word, lower, upper))
    j = np.arange(len(word))

    def rule(p):
        return new_instance(p, j, word, lower, upper)

    bits = ((j >= 2) & rule(np.maximum(j - 2, 0))) * NEW_SUB2
    bits |= ((j >= 1) & rule(np.maximum(j - 1, 0))) * NEW_SUB1
    bits |= rule(np.zeros_like(j)) * NEW_FROM0
    exits = np.flatnonzero(is_exit)
    for e in np.flatnonzero(is_entry):
        # Only the exits of e's own word can differ from "new" (another
        # word's pick always is).
        own = exits[(exits != e) & (word[exits] == word[e])]
        if not new_instance(own, np.full_like(own, e), word, lower, upper).all():
            raise ValueError(f"entry {e}: a pool pick from its own word's exits {own.tolist()} "
                             "would continue the word instance (each word needs its entry "
                             "first and its one exit last)")
    return bits.astype(np.int32)


def lattice_topology(log_a, lower_of_state, is_entry, is_exit, word_of_state=None,
                     device=None) -> LatticeTopology:
    """The composite's LatticeTopology on ``device`` (built on the host,
    uploaded once). word_of_state defaults to the runs of lower_of_state
    (words are contiguous, each starting at its entry)."""
    from ..viterbi import pack_coefs

    lower = _host(lower_of_state, np.int64)
    entry = _host(is_entry, bool)
    exit_ = _host(is_exit, bool)
    word = (np.unique(lower, return_inverse=True)[1] if word_of_state is None
            else _host(word_of_state, np.int64))
    s = len(lower)
    exits = np.flatnonzero(exit_).astype(np.int32)
    entries = np.flatnonzero(entry).astype(np.int32)
    # Words are contiguous runs of states: a state's word exit is the last
    # state of its run.
    upper = np.empty(s, np.int64)
    last = s - 1
    for j in range(s - 1, -1, -1):
        if j < s - 1 and word[j] != word[j + 1]:
            last = j
        upper[j] = last
    ints = np.stack([word, lower, upper, carry_bits(word, lower, upper, entry, exit_)]
                    ).astype(np.int32)
    coefs = pack_coefs(_host(log_a, np.float32), lower, entry, exit_, device="cpu")
    dev = torch.device(device) if device is not None else coefs.device
    return LatticeTopology(
        coefs=coefs.to(dev).contiguous(), ints=torch.as_tensor(ints, device=dev),
        exits=torch.as_tensor(exits, device=dev), entries=torch.as_tensor(entries, device=dev))


def topology_of(composite, dev) -> LatticeTopology:
    """The composite's LatticeTopology on ``dev``, built and uploaded once
    per composite and device and kept on the composite."""
    dev = torch.device(dev)
    cache = composite.__dict__.setdefault("_lattice_topology", {})
    key = (str(dev), id(composite.log_a))
    if key not in cache:
        cache[key] = lattice_topology(composite.log_a, composite.lower_of_state,
                                      composite.is_entry, composite.is_exit,
                                      composite.word_of_state, device=dev)
    return cache[key]


# -- the plain versions -------------------------------------------------------


def _entry_diag(topo: LatticeTopology, penalty):
    """d (S,): an entry's own cell of the dense matrix, max(penalty if the
    entry is also an exit, its self-loop); -inf off the entries."""
    c = topo.coefs
    pen = torch.tensor(penalty, dtype=torch.float32, device=c.device)
    own = torch.where(c[5] > 0, pen, torch.full_like(c[3], NEG))
    return torch.where(c[4] > 0, torch.maximum(own, c[3]), torch.full_like(c[3], NEG))


def _in_order(terms):
    """The sum of terms (..., L) along the last axis from +0, one term at a
    time in order (a zero term, the exp of -inf, leaves the sum as it is)."""
    acc = torch.zeros_like(terms[..., 0])
    for i in range(terms.shape[-1]):
        acc = acc + terms[..., i]
    return acc


def _lse_in_order(m, terms):
    """m + log(_in_order(exp(terms - m))) for m (...) and terms (..., L);
    -inf where m is."""
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    acc = _in_order(torch.exp(terms - m_safe[..., None]))
    return torch.where(fin, m + torch.log(acc), torch.full_like(m, NEG))


def _entry_column_order(entries, exits, s):
    """The forward's entry columns in the dense matrix's index order: for
    the n-th entry e, its terms' sources in cat([alpha + penalty (S), the
    entries' own cells (N), -inf]), ascending by state: each exit x at x,
    e's own cell (s + n) at e in place of e's exit term; padded with the
    -inf (s + N). (N, W + 1) int64."""
    n_e = len(entries)
    out = np.full((n_e, len(exits) + 1), s + n_e, np.int64)
    for n, e in enumerate(entries):
        col = sorted({*exits, e})
        out[n, : len(col)] = [s + n if u == e else u for u in col]
    return out


def _exit_row_order(entries, exits, s):
    """The backward's exit rows in the dense matrix's index order: for the
    n-th exit x, its terms' sources in cat([penalty + beta_em (S), the band
    cells t0 / t1 / t2 at the exits (3N), -inf]): each entry e != x at e,
    band cell k at x + k after an entry at the same index; padded with the
    -inf (s + 3N). (N, W + 3) int64."""
    n_x = len(exits)
    out = np.full((n_x, len(entries) + 3), s + 3 * n_x, np.int64)
    for n, x in enumerate(exits):
        row = sorted([(e, 0, e) for e in entries if e != x]
                     + [(x + k, 1, s + k * n_x + n) for k in range(3)])
        out[n, : len(row)] = [src for _i, _r, src in row]
    return out


def _lane_pool_sum(terms):
    """The factorized pool's sum: terms (..., W) in ascending member order,
    member i summed from +0 into lane i mod 32 one at a time, then the 32
    lanes by adjacent pairs level by level ((l0 + l1) + (l2 + l3)) + ...:
    the kernel's order (each warp's lanes, then the xor butterfly)."""
    w = terms.shape[-1]
    n = -(-w // 32)
    v = torch.cat([terms, terms.new_zeros((*terms.shape[:-1], 32 * n - w))], dim=-1)
    acc = _in_order(v.reshape(*terms.shape[:-1], n, 32).transpose(-1, -2))
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc[..., 0]


def _factorized_cells(pool_terms, members, own_state, excl, m, own, mp, band=()):
    """The pool cells of a pool past DENSE_POOL_MAX members: with u the
    members' dense cells (alpha[x] + penalty, or penalty + beta_em[e]) and
    mp their max, the pool's sum P = _lane_pool_sum(exp(u - mp)) (a
    single-state word that excludes itself sums exp(u - mp) over the other
    members one at a time, ascending, from +0), the cell is m + log(((band
    terms' exps in order) + P * exp(mp - m)) + exp(own - m)), -inf where m
    is. pool_terms (B, S): u; own_state, excl (N,); m, own, mp (B, N)."""
    v = pool_terms[:, members]
    a = mp[:, 0]
    fin_a = torch.isfinite(a)
    a_safe = torch.where(fin_a, a, torch.zeros_like(a))
    terms = torch.where(fin_a[:, None], torch.exp(v - a_safe[:, None]), torch.zeros_like(v))
    pool = _lane_pool_sum(terms)[:, None].expand(m.shape).clone()
    cols = torch.nonzero(excl).flatten()
    if len(cols):
        # Each excluding word's own member becomes a +0 term (index W).
        w = len(members)
        idx = torch.arange(w, device=m.device).repeat(len(cols), 1)
        idx[members[None, :] == own_state[cols][:, None]] = w
        padded = torch.cat([terms, torch.zeros_like(terms[:, :1])], dim=1)
        pool[:, cols] = _in_order(padded[:, idx])
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    acc = (_in_order(torch.exp(torch.stack(band, -1) - m_safe[..., None])) if band
           else torch.zeros_like(m))
    acc = acc + torch.where(torch.isfinite(mp), pool * torch.exp(mp - m_safe),
                            torch.zeros_like(m))
    acc = acc + torch.exp(own - m_safe)
    return torch.where(fin, m + torch.log(acc), torch.full_like(m, NEG))


def lattice_sum_passes_plain(log_b, topo: LatticeTopology, penalty, lengths):
    """LSUM, plain: log_b (B, T, S) float32, lengths (B,) -> (alphas
    (B, T, S), beta_em (B, T, S), beta_entry (B, T), log_z (B,)).

    JAX's _sum_passes_masked on the composite's dense matrix (the forward
    frozen at t >= length, the backward re-seeding the exit terminal at
    t == length - 1), each log-sum-exp m + log(sum) with m the max of its
    terms and the sum taken from +0 one term at a time in the dense
    matrix's index order (the kernel's order):
    - forward column j, a non-entry: alpha[j-2] + sub2[j], alpha[j-1] +
      sub1[j], alpha[j] + diag_ne[j]; an entry e: alpha[x] + penalty for
      each exit x ascending, with alpha[e] + d[e] at e's own index (d: the
      dense cell (e, e), max(penalty if e is an exit, its self-loop), which
      replaces e's own exit term); then + log_b[t, j];
    - backward row j on beta_em = log_b[t] + beta: the band c[j] +
      beta_em[j] (c = diag_ne, or d at an entry), sub1[j+1] + beta_em[j+1],
      sub2[j+2] + beta_em[j+2], and at an exit penalty + beta_em[e] for each
      entry e ascending (d[j] at j's own index), all in index order;
    - beta_entry[t] over the entries and log Z over the final alpha at the
      exits, ascending.
    A pool of more than DENSE_POOL_MAX members (exits for the forward's
    entry columns, entries for the backward's exit rows) is factorized
    instead, so a step costs O(W) and not O(W^2): one sum P a step over the
    members' dense cells u (alpha[x] + penalty, or penalty + beta_em[e]),
    _lane_pool_sum of exp(u - mp) with mp their max, is shared by the pool's
    cells, each m + log(((its band's exps) + P * exp(mp - m)) + exp(own -
    m)); the own dense cell stays apart (an entry's alpha[e] + diag, unless
    it is an exit whose penalty is at least its self-loop: then it is the
    pool's own term), and a single-state word whose self-loop beats the
    penalty sums the pool without itself (_factorized_cells).
    -inf wherever the max is -inf."""
    b, t_total, s = log_b.shape
    dev = log_b.device
    c = topo.coefs
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    entry, exit_ = c[4] > 0, c[5] > 0
    d = _entry_diag(topo, penalty)
    exits, entries = topo.exits.to(torch.int64), topo.entries.to(torch.int64)
    pen = torch.tensor(penalty, dtype=torch.float32, device=dev)
    neg = torch.full((b, s), NEG, device=dev)
    c1_next, c2_next = shift_states(c[1], -1), shift_states(c[2], -2)
    c_here = torch.where(entry, d, c[0])
    # Factorized pools: the own cell apart unless it is the pool's own term;
    # a single-state word whose self-loop beats the penalty excludes itself.
    in_pool = entry & exit_ & (pen >= c[3])
    excl = entry & exit_ & (c[3] > pen)

    def pool_max(values, members):  # a composite has an entry and an exit
        return values[:, members].max(dim=1).values

    def band_lse(t_a, t_b, t_c):
        return _lse_in_order(torch.maximum(torch.maximum(t_a, t_b), t_c),
                             torch.stack((t_a, t_b, t_c), -1))

    dense_fw, dense_bw = len(exits) <= DENSE_POOL_MAX, len(entries) <= DENSE_POOL_MAX
    ex_np, en_np = exits.tolist(), entries.tolist()
    if dense_fw:
        col_order = torch.as_tensor(_entry_column_order(en_np, ex_np, s), device=dev)
    if dense_bw:
        row_order = torch.as_tensor(_exit_row_order(en_np, ex_np, s), device=dev)
    neg_col = torch.full((b, 1), NEG, device=dev)

    alpha = torch.where(entry, log_b[:, 0] + c[6], neg)
    alphas = torch.empty((b, t_total, s), device=dev)
    alphas[:, 0] = alpha
    for t in range(1, t_total):
        t2 = shift_states(alpha, 2) + c[2]
        t1 = shift_states(alpha, 1) + c[1]
        t0 = alpha + c[0]
        new = band_lse(t2, t1, t0)
        own = alpha[:, entries] + d[entries]
        m_e = torch.maximum((pool_max(alpha, exits) + pen)[:, None], own)
        if dense_fw:
            cells = torch.cat([alpha + pen, own, neg_col], dim=1)
            new[:, entries] = _lse_in_order(m_e, cells[:, col_order])
        else:
            own_f = torch.where(in_pool[entries], NEG, own)
            mp = (pool_max(alpha, exits) + pen)[:, None].expand(own.shape)
            new[:, entries] = _factorized_cells(alpha + pen, exits, entries, excl[entries],
                                                torch.maximum(mp, own_f), own_f, mp)
        alpha = torch.where((t < lengths)[:, None], new + log_b[:, t], alpha)
        alphas[:, t] = alpha
    a_max = pool_max(alpha, exits)
    log_z = _lse_in_order(a_max, alpha[:, exits])

    terminal = torch.where(exit_, 0.0, NEG).expand(b, s)
    beta = terminal
    beta_em = torch.empty((b, t_total, s), device=dev)
    for t in range(t_total - 1, -1, -1):
        here = beta if t == 0 else torch.where((t == lengths - 1)[:, None], terminal, beta)
        bem = log_b[:, t] + here
        beta_em[:, t] = bem
        if t == 0:
            break
        t0 = c_here + bem
        t1 = c1_next + shift_states(bem, -1)
        t2 = c2_next + shift_states(bem, -2)
        beta = band_lse(t0, t1, t2)
        band = [x[:, exits] for x in (t0, t1, t2)]
        mq = (pool_max(bem, entries) + pen)[:, None].expand(band[0].shape)
        if dense_bw:
            m_x = torch.maximum(torch.maximum(torch.maximum(band[0], band[1]), band[2]), mq)
            cells = torch.cat([pen + bem, *band, neg_col], dim=1)
            beta[:, exits] = _lse_in_order(m_x, cells[:, row_order])
        else:
            band[0] = torch.where(in_pool[exits], NEG, band[0])
            m_x = torch.maximum(torch.maximum(torch.maximum(band[0], band[1]), band[2]), mq)
            beta[:, exits] = _factorized_cells(pen + bem, entries, exits, excl[exits], m_x,
                                               torch.full_like(m_x, NEG), mq, band)
    be = beta_em[:, :, entries]
    beta_entry = _lse_in_order(be.max(dim=2).values, be)
    return alphas, beta_em, beta_entry, log_z


def dense_transitions(topo: LatticeTopology, penalty) -> torch.Tensor:
    """The composite's dense (S, S) matrix (ops/viterbi
    composite_transition_matrix) rebuilt from the topology: the band
    diag_ne / sub1 / sub2 in non-entry columns; in an entry column e the
    penalty from every exit and max(penalty if e is an exit, diag_e) at
    (e, e)."""
    c = topo.coefs
    s = c.shape[1]
    dev = c.device
    entry, exit_ = c[4] > 0, c[5] > 0
    idx = torch.arange(s, device=dev)
    trans = torch.full((s, s), NEG, device=dev)
    trans[idx, idx] = c[0]
    trans[idx[:-1], idx[1:]] = c[1][1:]
    trans[idx[:-2], idx[2:]] = c[2][2:]
    pen = torch.tensor(penalty, dtype=torch.float32, device=dev)
    col = torch.where(exit_[:, None], pen, torch.tensor(NEG, device=dev)).expand(s, s)
    trans = torch.where(entry[None, :], col, trans)
    self_e = torch.maximum(torch.where(exit_, pen, torch.tensor(NEG, device=dev)), c[3])
    trans[idx[entry], idx[entry]] = self_e[entry]
    return trans


def lattice_max_passes_plain(log_b, topo: LatticeTopology, penalty, length: int):
    """LMAX, plain: log_b (T, S) float32 -> (alphas (T, S), entry times
    (T, S) int32, beta_entry (T,), score): JAX's _lattice_passes_impl on the
    dense matrix. The forward's argmax is torch.max's first max over the
    dense column; a new word instance starts where the predecessor lies in
    another word, or on an exit -> entry re-entry of the same word. Rows at
    t >= length keep the carry (the forward) or are garbage (the
    backward): read only frames < length."""
    t_total, s = log_b.shape
    dev = log_b.device
    trans = dense_transitions(topo, penalty)
    c, ints = topo.coefs, topo.ints.to(torch.int64)
    entry, exit_ = c[4] > 0, c[5] > 0
    word_of, lower, upper = ints[:3]
    sidx = torch.arange(s, device=dev)
    alpha = torch.where(entry, log_b[0] + c[6], NEG)
    et = torch.zeros((s,), dtype=torch.int64, device=dev)
    alphas = torch.empty((t_total, s), device=dev)
    ets = torch.empty((t_total, s), dtype=torch.int32, device=dev)
    alphas[0], ets[0] = alpha, et
    for t in range(1, t_total):
        new_alpha, bp = torch.max(alpha[:, None] + trans, dim=0)
        new_alpha = new_alpha + log_b[t]
        new_inst = (bp != sidx) & ((word_of[bp] != word_of) | ((bp == upper) & (sidx == lower)))
        new_et = torch.where(new_inst, t, et[bp])
        if t < length:
            alpha, et = new_alpha, new_et
        alphas[t], ets[t] = alpha, et

    beta_last = torch.where(exit_, 0.0, NEG)
    beta = beta_last
    beta_em = torch.empty((t_total, s), device=dev)
    for t in range(t_total - 1, 0, -1):
        here = beta_last if t == length - 1 else beta
        beta_em[t] = log_b[t] + here
        beta = torch.max(trans + beta_em[t][None, :], dim=1).values
    beta_em[0] = log_b[0] + beta
    beta_entry = torch.where(entry[None, :], beta_em, NEG).max(dim=1).values
    score = torch.where(exit_, alpha, NEG).max()
    return alphas, ets, beta_entry, score


def top_k(x: torch.Tensor, k: int):
    """The k largest values of the last axis and their indices, best first,
    the lower index first among equal values (jax.lax.top_k's order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def kbest_forward_plain(log_b, topo: LatticeTopology, penalty, k: int, length=None):
    """KBEST, plain: log_b (T, S) float32 -> (alpha (S, K) final scores,
    bps (T, S, K) int32 = pred_state * K + pred_slot, -1 on row 0): JAX's
    kbest_composite_forward. A non-entry takes the stable top K of its
    banded candidates [s-2 block, s-1 block, s block]; an entry the stable
    top K of [the exit pool's top K + penalty, its own K self-loops]; a
    single-state word keeps one copy of a hypothesis that reaches it both
    ways (the pool's when the penalty is at least the self-loop). Steps at
    t >= length keep alpha and still write bps."""
    t_total, s = log_b.shape
    dev = log_b.device
    length = t_total if length is None else int(length)
    coefs = topo.coefs
    diag_ne, sub1, sub2, diag_e = coefs[0], coefs[1], coefs[2], coefs[3]
    entry, exit_ = coefs[4] > 0, coefs[5] > 0
    penalty = torch.tensor(penalty, dtype=torch.float32, device=dev)
    to = torch.arange(s, device=dev)
    lanes = torch.arange(k, device=dev)
    pred_state_ne = torch.stack([(to - 2).clamp(min=0), (to - 1).clamp(min=0), to], dim=1)
    both = entry & exit_
    slot_ids = to[:, None] * k + lanes[None, :]  # (S, K)
    # Single-state words (entry and exit): a pool candidate and a self-loop
    # candidate can carry the same predecessor; the pool keeps it when the
    # penalty is at least the self-loop (same alpha on both sides).
    pool_beats = (penalty >= diag_e)[:, None]
    neg_row = torch.full((1, k), NEG, device=dev)

    alpha = torch.full((s, k), NEG, device=dev)
    alpha[:, 0] = torch.where(entry, log_b[0] + coefs[6], NEG)
    bps = torch.empty((t_total, s, k), dtype=torch.int32, device=dev)
    bps[0] = -1
    for t in range(1, t_total):
        a1 = torch.cat([neg_row, alpha[:-1]], dim=0)
        a2 = torch.cat([neg_row, neg_row, alpha[:-2]], dim=0)[:s]
        cand_ne = torch.cat([a2 + sub2[:, None], a1 + sub1[:, None],
                             alpha + diag_ne[:, None]], dim=1)  # (S, 3K)
        top_ne, idx_ne = top_k(cand_ne, k)
        bp_ne = pred_state_ne.gather(1, idx_ne // k) * k + idx_ne % k

        pool = torch.where(exit_[:, None], alpha, NEG).reshape(-1)
        pool_top, pool_idx = top_k(pool, k)
        c_pen = pool_top + penalty
        c_self = alpha + diag_e[:, None]
        dup_self = both[:, None] & (slot_ids[:, :, None] == pool_idx[None, None, :]).any(-1)
        c_self = torch.where(dup_self & pool_beats, NEG, c_self)
        dup_pool = both[:, None] & (pool_idx[None, :] // k == to[:, None])
        c_pen_row = torch.where(dup_pool & ~pool_beats, NEG, c_pen[None, :].expand(s, k))
        top_e, idx_e = top_k(torch.cat([c_pen_row, c_self], dim=1), k)
        bp_pool = pool_idx[None, :].expand(s, k).gather(1, idx_e.clamp(max=k - 1))
        bp_e = torch.where(idx_e < k, bp_pool, to[:, None] * k + (idx_e - k))

        entry_col = entry[:, None]
        bps[t] = torch.where(entry_col, bp_e, bp_ne).to(torch.int32)
        if t < length:
            alpha = torch.where(entry_col, top_e, top_ne) + log_b[t][:, None]
    return alpha, bps


# -- the kernels' wrappers ----------------------------------------------------


def _check_topology(topo: LatticeTopology, s: int, dev) -> None:
    if topo.num_states != s:
        raise ValueError(f"topology of {topo.num_states} states vs log_b of {s}")
    if topo.device != dev:
        raise ValueError(f"topology on {topo.device}, log_b on {dev}")
    for name, x, dtype in (("coefs", topo.coefs, torch.float32),
                           ("ints", topo.ints, torch.int32),
                           ("exits", topo.exits, torch.int32),
                           ("entries", topo.entries, torch.int32)):
        _check_cuda(name, x, dtype)
    if not 1 <= s <= MAX_LATTICE_STATES:
        raise ValueError(f"{s} composite states; the lattice kernels take "
                         f"1..{MAX_LATTICE_STATES}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _plan(fn, *args, n=6) -> list:
    out = (ctypes.c_int * n)()
    _build.check(fn(*args, out), fn.__name__)
    return list(out)


def lattice_sum_plan(s: int, n_exits: int, n_entries: int) -> dict:
    """LSUM's launch at S states and these pool sizes, as the library
    decides it: the branch ("team": band warps beside pool warps; "simple":
    the first design, where one pool is dense and the other not, or the
    threads do not fit), states a band thread (a thread on the simple
    branch), the dense pool's unrolled bucket (0: factorized), pool warps,
    threads a block and the build's cells a pool lane."""
    b, k, wb, npw, threads, cpl = _plan(_build.load().cs304_lattice_sum_plan, s, n_exits,
                                        n_entries)
    return {"branch": ("team", "simple")[b], "k": k, "bucket": wb, "pool_warps": npw,
            "threads": threads, "cells_a_lane": cpl}


def lattice_max_plan(s: int, n_exits: int, n_entries: int) -> dict:
    """LMAX's launch at S states and these pool sizes, as the library
    decides it: the branch ("team": band threads beside pool warps; "simple":
    the first design, where the pool's cells or the threads do not fit),
    states a band thread (a thread on the simple branch), the pool ("dense":
    one pool warp reading its members after the barrier; "factorized": the
    members' partials in parity slots; always on a cluster), pool warps,
    threads a block, the build's cells a pool lane and the CTAs a pass (a
    cluster of 2 or 4 at 4 states a band thread, where one CTA's band would
    need more)."""
    b, k, dense, npw, threads, cpl, ctas = _plan(_build.load().cs304_lattice_max_plan, s,
                                                 n_exits, n_entries, n=7)
    return {"branch": ("team", "simple")[b], "k": k,
            "pool": "dense" if dense else "factorized", "pool_warps": npw,
            "threads": threads, "cells_a_lane": cpl, "ctas": ctas}


def kbest_plan(s: int, k: int, n_exits: int) -> dict:
    """KBEST's launch at S states, K and the exit count: the branch ("team":
    a team of lanes a state, K in a bucket of 1 / 2 / 4 / 8 / 16 / 32, its
    rows in shared memory; "simple": the first design, past K = 32, 128 exit
    rows or rows beyond shared memory), the bucket, threads and where its
    rows live."""
    b, kb, threads, _unused, glob, _unused = _plan(_build.load().cs304_kbest_plan, s, k,
                                                   n_exits)
    return {"branch": ("team", "simple")[b], "bucket": kb, "threads": threads,
            "rows": "global" if glob else "shared"}


def lattice_sum_passes(log_b, topo: LatticeTopology, penalty, lengths, simple=False):
    """LSUM (see lattice_sum_passes_plain): log_b (B, T, S) float32,
    lengths (B,) int32 -> (alphas (B, T, S), beta_em (B, T, S), beta_entry
    (B, T), log_z (B,)) float32. On CUDA tensors one launch: a block a
    row's forward and a block its backward (lattice_sum_plan's branch, or
    the first design with simple=True)."""
    if not log_b.is_cuda:
        return lattice_sum_passes_plain(log_b, topo, penalty, lengths)
    b, t_total, s = log_b.shape
    _check_cuda("log_b", log_b, torch.float32)
    _check_cuda("lengths", lengths, torch.int32)
    if lengths.shape != (b,) or lengths.device != log_b.device:
        raise ValueError(f"lengths {tuple(lengths.shape)} on {lengths.device} vs log_b "
                         f"{tuple(log_b.shape)} on {log_b.device}")
    if b < 1 or t_total < 1:
        raise ValueError(f"empty batch: B={b}, T={t_total}")
    _check_topology(topo, s, log_b.device)
    dev = log_b.device
    lib = _build.load()
    if lib.cs304_lattice_dense_pool_max() != DENSE_POOL_MAX:
        raise RuntimeError(f"the LSUM kernel factorizes pools past "
                           f"{lib.cs304_lattice_dense_pool_max()} members, its plain version "
                           f"past DENSE_POOL_MAX = {DENSE_POOL_MAX}")
    alphas = torch.empty((b, t_total, s), dtype=torch.float32, device=dev)
    beta_em = torch.empty((b, t_total, s), dtype=torch.float32, device=dev)
    beta_entry = torch.empty((b, t_total), dtype=torch.float32, device=dev)
    log_z = torch.empty((b,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.cs304_lattice_sum(
            log_b.data_ptr(), topo.coefs.data_ptr(), topo.ints.data_ptr(),
            topo.exits.data_ptr(), topo.entries.data_ptr(), lengths.data_ptr(),
            float(penalty), alphas.data_ptr(), beta_em.data_ptr(),
            beta_entry.data_ptr(), log_z.data_ptr(), b, t_total, s, topo.exits.numel(),
            topo.entries.numel(), int(simple), _stream())
    _build.check(code, "lattice_sum_passes")
    lattice_sum_passes.launches += 1
    return alphas, beta_em, beta_entry, log_z


lattice_sum_passes.launches = 0


def lattice_max_passes(log_b, topo: LatticeTopology, penalty, length: int, simple=False):
    """LMAX (see lattice_max_passes_plain): log_b (T, S) float32 ->
    (alphas (T, S) float32, entry times (T, S) int32, beta_entry (T,)
    float32, score (0-d float32)). On CUDA tensors one launch: a block
    for the forward and a block for the backward (lattice_max_plan's
    branch, or the first design with simple=True), bitwise the plain
    version."""
    if not log_b.is_cuda:
        return lattice_max_passes_plain(log_b, topo, penalty, length)
    t_total, s = log_b.shape
    _check_cuda("log_b", log_b, torch.float32)
    if t_total < 1:
        raise ValueError("empty utterance: T=0")
    _check_topology(topo, s, log_b.device)
    dev = log_b.device
    lib = _build.load()
    alphas = torch.empty((t_total, s), dtype=torch.float32, device=dev)
    ets = torch.empty((t_total, s), dtype=torch.int32, device=dev)
    beta_entry = torch.empty((t_total,), dtype=torch.float32, device=dev)
    score = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.cs304_lattice_max(
            log_b.data_ptr(), topo.coefs.data_ptr(), topo.ints.data_ptr(),
            topo.exits.data_ptr(), topo.entries.data_ptr(), float(penalty), int(length),
            alphas.data_ptr(), ets.data_ptr(), beta_entry.data_ptr(), score.data_ptr(),
            t_total, s, topo.exits.numel(), topo.entries.numel(), int(simple), _stream())
    _build.check(code, "lattice_max_passes")
    lattice_max_passes.launches += 1
    return alphas, ets, beta_entry, score


lattice_max_passes.launches = 0


def kbest_forward(log_b, topo: LatticeTopology, penalty, k: int, length=None, simple=False):
    """KBEST (see kbest_forward_plain): log_b (T, S) float32 -> (alpha
    (S, K) float32, bps (T, S, K) int32). On CUDA tensors one launch of one
    block, bitwise the plain version; any K >= 1 (the hypothesis rows live
    in shared memory where they fit, else in a device scratch;
    kbest_plan's branch, or the first design with simple=True)."""
    if not log_b.is_cuda:
        return kbest_forward_plain(log_b, topo, penalty, k, length)
    t_total, s = log_b.shape
    _check_cuda("log_b", log_b, torch.float32)
    if t_total < 1 or k < 1:
        raise ValueError(f"empty k-best forward: T={t_total}, K={k}")
    if s * k >= 2**31:
        raise ValueError(f"S * K = {s * k} overflows the int32 backpointer codes")
    _check_topology(topo, s, log_b.device)
    length = t_total if length is None else int(length)
    dev = log_b.device
    lib = _build.load()
    alpha = torch.empty((s, k), dtype=torch.float32, device=dev)
    bps = torch.empty((t_total, s, k), dtype=torch.int32, device=dev)
    words = lib.cs304_kbest_scratch_words(s, k)
    scratch = torch.empty((max(words, 1),), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.cs304_kbest_forward(
            log_b.data_ptr(), topo.coefs.data_ptr(), topo.exits.data_ptr(), float(penalty),
            length, k, alpha.data_ptr(), bps.data_ptr(), scratch.data_ptr(), t_total, s,
            topo.exits.numel(), int(simple), _stream())
    _build.check(code, "kbest_forward")
    kbest_forward.launches += 1
    return alpha, bps


kbest_forward.launches = 0
