"""The constrained searches' kernels (csrc/trellis_constrained.cu), held on
the CPU through their host tables and their step order.

- The wrappers' host tables: counted decoding's chain automaton
  (ops/viterbi_counted.chain_grammar) run through the plain grammar
  trellis equals the plain counted trellis (scores, and the paths of every
  finite row), count ranges included; the routing table
  (ops/cuda/trellis_constrained.routing_table) lists exactly the source
  planes the plain grammar trellis's ``route`` selects, for WordDFA's
  builders; the stay and advance coefficients are the plain versions'
  transition matrices on their band.
- The team kernels' step order, emulated in numpy float32 on those tables
  (PLANES: each warp's best exit, one barrier, then each entry's cross
  move over its source planes' folded partials with the penalty added
  after the max, stay against cross with the exit winning ties; DURATION:
  inside the lane each state's best completed slot, the stay shift with
  its saturation and the best two exit sums, then the advance comparing
  sums, an entry that is an exit taking the second best where the best is
  its own), one code byte a cell and the per-step best exits walked back
  with K2-bt's semantics: bitwise the plain versions in scores and in the
  paths of every finite row, on random composites (a one-state word
  included) with tie-heavy emissions, ragged lengths, rows with no
  admissible path, a penalty large enough that a + p == b + p for a != b,
  and a path through the second-best exit.

The JAX package is these searches' oracle in tests/test_torch_constrained.py;
the kernels themselves run in tests/test_torch_cuda_kernels.py on the card.
"""
import numpy as np
import pytest
import torch

from cs304_tpu_torch.models.hmm import CompositeHMM, flagship_composite
from cs304_tpu_torch.ops import grammar as tg
from cs304_tpu_torch.ops import viterbi_counted as tvc
from cs304_tpu_torch.ops import viterbi_duration as tvd
from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs
from cs304_tpu_torch.ops.viterbi import composite_transition_matrix
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

F32 = np.float32
NEG = F32(-np.inf)


def _composite(seed, labels=("1", "2", "3", "S"), states=(3, 2, 4, 2), penalty=-3.0):
    """Words with random left-to-right transitions (skips and self-loops)."""
    rng = np.random.default_rng(seed)
    s_total = sum(states)
    log_a = np.full((s_total, s_total), -np.inf, F32)
    base = 0
    for c in states:
        block = np.zeros((c, c))
        for i in range(c):
            row = rng.random(min(c - i, 3)) + 0.1
            block[i, i: i + len(row)] = row / row.sum()
        with np.errstate(divide="ignore"):
            log_a[base: base + c, base: base + c] = np.log(block)
        base += c
    d = 4
    return CompositeHMM(list(labels), list(states), rng.normal(size=(s_total, d)).astype(F32),
                        np.tile(np.eye(d, dtype=F32), (s_total, 1, 1)), log_a, penalty)


COMPOSITES = {
    "random": lambda: _composite(0),
    "one-state-word": lambda: _composite(1, states=(3, 1, 4, 2)),
    "huge-penalty": lambda: _composite(2, penalty=-3e9),
    "flagship": flagship_composite,
    # 302 states: four states a lane, a plane of three warps.
    "wide": lambda: _composite(3, labels=tuple(str(i) for i in range(30)) + ("S",),
                               states=(10,) * 30 + (2,)),
}


def _log_b(comp, seed, lengths, ties):
    rng = np.random.default_rng(seed)
    shape = (len(lengths), max(lengths), comp.num_states)
    if ties:  # a coarse grid: many exactly equal candidates
        return rng.integers(-3, 1, size=shape).astype(F32)
    return (rng.normal(size=shape) * 3).astype(F32)


def _topo(comp):
    return comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit


def _assert_same(got, want):
    """Scores everywhere (-inf included), paths on the finite rows."""
    gs, gp = (np.asarray(x) for x in got)
    ws, wp = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gs, ws)
    finite = np.isfinite(ws)
    np.testing.assert_array_equal(gp[finite], wp[finite])
    return finite


# -- host tables --------------------------------------------------------------
@pytest.mark.parametrize("n_words,n_min", [(1, None), (2, None), (3, None), (3, 1), (4, 2)])
@pytest.mark.parametrize("name", ["random", "one-state-word", "flagship"])
def test_chain_grammar_is_the_counted_search(name, n_words, n_min):
    comp = COMPOSITES[name]()
    lengths = np.asarray([14, 9, 3, 14, 1, 6], np.int32)
    log_b = torch.as_tensor(_log_b(comp, n_words, lengths, ties=n_words % 2 == 0))
    counted = comp.word_of_state != comp.labels.index("S")
    want = tvc.viterbi_composite_counted_batch_plain(
        log_b, *_topo(comp), counted, comp.penalty, n_words, lengths, n_words_min=n_min)
    word, next_state, accept = tvc.chain_grammar(counted, n_words, n_min)
    got = tg.viterbi_composite_grammar_batch_plain(
        log_b, *_topo(comp), word, next_state, accept, comp.penalty, lengths)
    finite = _assert_same(got, want)
    assert finite.any()
    # The dispatcher takes a CPU tensor to the plain version.
    _assert_same(tvc.viterbi_composite_counted_batch(
        log_b, *_topo(comp), counted, comp.penalty, n_words, lengths, n_words_min=n_min), want)


def _grammars(labels):
    return {
        "strings": tg.WordDFA.from_strings(["12", "213", "3", "1"], labels),
        "positions": tg.WordDFA.from_positions([("1", "2"), ("1", "2", "3"), ("3",)], labels),
        "count": tg.WordDFA.exact_count(2, labels),
        "count-range": tg.WordDFA.exact_count(3, labels, n_words_min=1),
        "merge": _merge_dfa(labels),
    }


def _merge_dfa(labels):
    """Planes 1 and 2 both lead to plane 3 by words "1" and "3": a cross
    move with two source planes, where the max over raw alpha and the max
    over alpha + penalty can pick different planes."""
    ns = np.full((4, len(labels)), -1, np.int32)
    w = {lab: i for i, lab in enumerate(labels)}
    ns[0, w["1"]], ns[0, w["2"]] = 1, 2
    ns[1, w["1"]] = ns[2, w["1"]] = ns[1, w["3"]] = ns[2, w["3"]] = 3
    ns[:, w["S"]] = np.arange(4)
    return tg.WordDFA(ns, np.asarray([False, False, False, True]), list(labels))


@pytest.mark.parametrize("kind", ["strings", "positions", "count", "count-range", "merge"])
def test_routing_table_lists_the_planes_route_selects(kind):
    dfa = _grammars(["1", "2", "3", "S"])[kind]
    ns = torch.as_tensor(dfa.next_state).to(torch.int64)
    g, w = ns.shape
    route = ns[:, None, :] == torch.arange(g)[None, :, None]   # [src, dst, w], as ops/grammar
    offsets, sources = tcs.routing_table(dfa.next_state)
    assert offsets.shape == (g * w + 1,) and offsets[0] == 0 and offsets[-1] == len(sources)
    for dst in range(g):
        for word in range(w):
            listed = sources[offsets[dst * w + word]: offsets[dst * w + word + 1]]
            np.testing.assert_array_equal(listed, torch.nonzero(route[:, dst, word])[:, 0])


@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_coefficients_are_the_plain_matrices_on_their_band(name):
    comp = COMPOSITES[name]()
    s = comp.num_states
    stay = tvc._stay_matrix(comp.log_a, comp.lower_of_state, comp.is_entry).numpy()
    coefs = tcs.stay_coefs(comp.log_a, comp.lower_of_state, comp.is_entry)
    rebuilt = np.full((s, s), -np.inf, F32)
    for row, k in enumerate((2, 1, 0)):
        j = np.arange(k, s)
        rebuilt[j - k, j] = coefs[row, k:]
    np.testing.assert_array_equal(rebuilt, stay)
    m_adv = composite_transition_matrix(comp.log_a, comp.lower_of_state, comp.is_entry,
                                        comp.is_exit, comp.penalty).numpy()
    np.fill_diagonal(m_adv, -np.inf)
    ftab, ints = tcs.duration_tables(comp.log_a, comp.lower_of_state, comp.is_entry,
                                     comp.is_exit, np.ones(s), np.full(s, tvd.UNBOUNDED))
    entry, exit_ = comp.is_entry.astype(bool), comp.is_exit.astype(bool)
    rebuilt = np.full((s, s), -np.inf, F32)
    for row, k in enumerate((2, 1)):
        j = np.arange(k, s)
        rebuilt[j - k, j] = ftab[row, k:]
    pen = F32(comp.penalty)
    rebuilt[np.ix_(exit_, entry)] = pen
    np.fill_diagonal(rebuilt, -np.inf)
    np.testing.assert_array_equal(rebuilt, m_adv)
    np.testing.assert_array_equal(ftab[2], np.diagonal(comp.log_a))
    np.testing.assert_array_equal(ints["exits"], np.nonzero(exit_)[0])


# -- the kernels' step order --------------------------------------------------
BIG = np.iinfo(np.int64).max


def _walk_codes(t_n, length, steps, start, quirk, prev, state_of):
    """The team kernels' walk (csrc/trellis_constrained.cu:walk_codes, K2-bt's
    semantics and quirk): prev(t, cell) steps back from row t."""
    p = np.full(t_n, state_of(start), np.int64)
    second = min(max(length - 2, 0), t_n - 1)
    cell, at_second = start, state_of(start)
    for t in range(steps - 1, 0, -1):
        p[t] = state_of(cell)
        if t == second:
            at_second = p[t]
        cell = prev(t, cell)
    p[0] = state_of(cell)
    if second == 0:
        at_second = p[0]
    last = max(length - 1, 0)
    if quirk and last < t_n:
        p[last] = at_second
    return p


def _better(v, i, bv, bi):
    return v > bv or (v == bv and i < bi)


def _first_best(vals, idx):
    """better()'s winner over (vals, idx) pairs given in ascending idx: the
    max, the lowest index holding it, that index's own value (its sign of
    zero); (-inf, BIG) for none."""
    if len(vals) == 0:
        return NEG, BIG
    at = int(np.argmax(vals == vals.max()))
    return vals[at], int(idx[at])


def _lane_states(s):
    return 2 if s <= 64 else (4 if s <= 2048 else 8)


def emulate_planes(log_b, lengths, ftab, tab, penalty, quirk=True):
    """The PLANES team kernel, step by step, in numpy float32: each warp's
    best exit over its 32 K states of a plane (the per-warp partials), ONE
    barrier, then each cell's stay (j-2, j-1, j; a strict > from -inf) and
    each entry's cross move over its (plane, word)'s source planes in
    ascending order (each source's best exit folded from its warps'
    partials, a strict > on the raw maxima, the penalty after), the exit
    winning a tie; one code byte a cell (0-2 the stay from j - c, 3 | g' << 2
    the cross) and one int16 best exit a plane a step, walked back."""
    word, seed = tab["itab"]
    exits, off, src, acc = tab["exits"], tab["route_off"], tab["route_src"], tab["accept"]
    g_n, (b_n, t_n, s) = len(acc), log_b.shape
    w_n = (len(off) - 1) // g_n
    c2, c1, c0, a0 = ftab
    pen = F32(penalty)
    span = 32 * _lane_states(s)
    wp = -(-s // span)
    warp_exits = [exits[(exits >= w * span) & (exits < (w + 1) * span)] for w in range(wp)]
    sources = [src[off[p]: off[p + 1]] for p in range(g_n * w_n)]
    j = np.arange(s)
    ent = word >= 0
    scores, paths = np.zeros(b_n, F32), np.zeros((b_n, t_n), np.int64)
    for b in range(b_n):
        alpha = np.where(seed[None, :] == np.arange(g_n)[:, None], log_b[b, 0] + a0, NEG)
        steps = min(max(int(lengths[b]), 1), t_n)
        codes = np.zeros((t_n, g_n, s), np.int64)
        bex = np.zeros((t_n, g_n), np.int64)

        def plane_best():
            """Each warp's partial, then each plane's fold of its warps'."""
            out = []
            for g in range(g_n):
                parts = [_first_best(alpha[g, xs], xs) for xs in warp_exits]
                out.append(_first_best(np.asarray([v for v, _i in parts], F32),
                                       np.asarray([i for _v, i in parts])))
            return out

        for t in range(1, steps):
            best = plane_best()  # published before the barrier
            bex[t] = [i if v > NEG else 0 for v, i in best]
            stay = np.full((g_n, s), NEG)
            code = np.zeros((g_n, s), np.int64)
            for k, coef in ((2, c2), (1, c1), (0, c0)):
                prev = np.full((g_n, s), NEG)
                prev[:, k:] = alpha[:, : s - k]
                v = prev + coef
                take = v > stay
                stay, code = np.where(take, v, stay), np.where(take, k, code)
            new = stay.copy()
            for g in range(g_n):
                for jj in np.nonzero(ent)[0]:
                    bv, sp = NEG, 0
                    for g2 in sources[g * w_n + word[jj]]:
                        if best[g2][0] > bv:
                            bv, sp = best[g2][0], g2
                    cross = F32(bv + pen)
                    if cross >= stay[g, jj]:
                        code[g, jj] = 3 | (sp << 2)
                    new[g, jj] = np.maximum(stay[g, jj], cross)
            alpha = (new + log_b[b, t]).astype(F32)
            codes[t] = code
        bv, cell = NEG, BIG
        for g, (v, i) in enumerate(plane_best()):
            if acc[g] and i != BIG and _better(v, g * s + i, bv, cell):
                bv, cell = v, g * s + i
        scores[b] = bv

        def prev(t, c):
            g, jj = divmod(c, s)
            k = codes[t, g, jj]
            if k & 3 == 3:
                return (k >> 2) * s + bex[t, k >> 2]
            return g * s + max(jj - (k & 3), 0)

        paths[b] = _walk_codes(t_n, int(lengths[b]), steps, 0 if cell == BIG else cell, quirk,
                               prev, lambda c: c % s)
    return scores, paths


def emulate_duration(log_b, lengths, ftab, tab, penalty, d_n, quirk=True, walked=None):
    """The DURATION team kernel, step by step, in numpy float32: inside each
    lane each state's best completed slot, the stay shift of slots >= 1 and
    the best exit sums, the best two where an entry is also an exit; after
    the barrier slot 0 (an entry the best exit sum, an entry that is an exit
    the second best where the best is its own; a non-entry the advance from
    j-2, then j-1, sums compared); one code byte a cell (d >= 1: 0 the
    shift, 1 the saturated stay; d = 0: kind | slot << 3, kind 1 / 2 the
    advance from j - kind, 3 / 4 the best / second-best exit cell of the
    step's two), walked back. walked, a list, collects the codes the walks
    read."""
    flags, min_dur, max_dur = tab["itab"]
    exits = tab["exits"]
    m2, m1, diag, a0 = ftab
    pen = F32(penalty)
    b_n, t_n, s = log_b.shape
    two = bool(((flags & 3) == 3).any())
    scores, paths = np.zeros(b_n, F32), np.zeros((b_n, t_n), np.int64)
    for b in range(b_n):
        alpha = np.full((s, d_n), NEG)
        alpha[:, 0] = np.where(flags & 1, log_b[b, 0] + a0, NEG)
        steps = min(max(int(lengths[b]), 1), t_n)
        codes = np.zeros((t_n, s, d_n), np.int64)
        bex = np.zeros((t_n, 2), np.int64)
        for t in range(1, steps):
            # Inside the lane: best completed slots, stays, exit sums.
            bc_val, bc_d = np.full(s, NEG), np.zeros(s, np.int64)
            new = np.full((s, d_n), NEG)
            for st in range(s):
                for d in range(max(min_dur[st] - 1, 0), d_n):
                    if alpha[st, d] > bc_val[st]:
                        bc_val[st], bc_d[st] = alpha[st, d], d
                for d in range(1, d_n):
                    sh = alpha[st, d - 1]
                    if d == d_n - 1 and flags[st] & 4:
                        sh = np.maximum(sh, alpha[st, d])
                        codes[t, st, d] = int(alpha[st, d] > alpha[st, d - 1])
                    new[st, d] = sh + diag[st] if d + 1 <= max_dur[st] else NEG
            top = [(NEG, BIG), (NEG, BIG)]
            for x in exits:  # better()'s best two, (sum, cell)
                v, c = F32(bc_val[x] + pen), x * d_n + bc_d[x]
                if _better(v, c, *top[0]):
                    top = [(v, c), top[0]]
                elif two and _better(v, c, *top[1]):
                    top[1] = (v, c)
            bex[t] = [0 if c == BIG else c for _v, c in top]
            # After the barrier: slot 0.
            for st in range(s):
                if flags[st] & 1:
                    own = bool(flags[st] & 2) and top[0][1] // d_n == st
                    new[st, 0], codes[t, st, 0] = top[1][0] if own else top[0][0], 4 if own else 3
                else:
                    best, code = NEG, 0
                    for k, coef in ((2, m2), (1, m1)):
                        u = bc_val[st - k] + coef[st] if st >= k else NEG
                        if u > best:
                            best, code = u, k | (bc_d[st - k] << 3)
                    new[st, 0], codes[t, st, 0] = best, code
            alpha = (new + log_b[b, t][:, None]).astype(F32)
        bv, cell = NEG, BIG
        for x in exits:
            for d in range(d_n):
                if d + 1 >= min_dur[x] and _better(alpha[x, d], x * d_n + d, bv, cell):
                    bv, cell = alpha[x, d], x * d_n + d
        scores[b] = bv

        def prev(t, c):
            st, d = divmod(c, d_n)
            k = codes[t, st, d]
            if walked is not None:
                walked.append((d, k))
            if d > 0:
                return c if k else c - 1
            if k & 7 in (3, 4):
                return bex[t, (k & 7) - 3]
            return max(st - (k & 7), 0) * d_n + (k >> 3)

        paths[b] = _walk_codes(t_n, int(lengths[b]), steps, 0 if cell == BIG else cell, quirk,
                               prev, lambda c: c // d_n)
    return scores, paths


PLANE_CASES = {
    "count-1": ("random", "count", 1, False),
    "count-3-ties": ("random", "count", 3, True),
    "count-range-ties": ("one-state-word", "count-range", None, True),
    "strings": ("random", "strings", None, False),
    "strings-ties": ("one-state-word", "strings", None, True),
    "positions": ("huge-penalty", "positions", None, False),
    "count-huge-penalty": ("huge-penalty", "count", 2, False),
    "merge": ("random", "merge", None, True),
    "merge-huge-penalty": ("huge-penalty", "merge", None, False),
    "wide-count-2": ("wide", "count", 2, False),
    "wide-merge-ties": ("wide", "merge", None, True),
}


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_planes_step_order_is_bitwise_plain(case):
    name, kind, n_words, ties = PLANE_CASES[case]
    comp = COMPOSITES[name]()
    # The huge penalty rounds alpha + penalty to a grid of 256: more rows give
    # more steps whose best two sources tie only after the add.
    lengths = np.asarray([13, 8, 2, 13, 1, 5] * (16 if name == "huge-penalty" else 4), np.int32)
    log_b = _log_b(comp, len(case), lengths, ties)
    if kind == "count":
        counted = comp.word_of_state != comp.labels.index("S")
        word, next_state, accept = tvc.chain_grammar(counted, n_words)
        want = tvc.viterbi_composite_counted_batch_plain(
            torch.as_tensor(log_b), *_topo(comp), counted, comp.penalty, n_words, lengths)
    else:
        dfa = _grammars(comp.labels)[kind]
        word, next_state, accept = comp.word_of_state, dfa.next_state, dfa.accept
        want = tg.viterbi_composite_grammar_batch_plain(
            torch.as_tensor(log_b), *_topo(comp), word, next_state, accept, comp.penalty,
            lengths)
    ftab, tab = tcs.planes_tables(*_topo(comp), word, next_state, accept)
    got = emulate_planes(log_b, lengths, ftab, tab, comp.penalty)
    finite = _assert_same(got, want)
    # Rows with and without a path (a one-word range admits every row).
    assert finite.any() and (kind == "count-range" or not finite.all())


DURATION_CASES = {
    "min-1": ("random", 1, None, False, False),
    "min-2": ("random", 2, None, False, False),
    "min-2-ties": ("random", 2, None, False, True),
    "min-2-max-3": ("random", 2, 3, False, True),
    "per-word-silence": ("random", {"1": 3, "2": 1}, 4, True, True),
    "huge-penalty": ("huge-penalty", 1, 2, True, False),
    "one-state-word": ("one-state-word", 2, None, False, True),
    "wide-min-2-max-4": ("wide", 2, 4, False, False),
}


@pytest.mark.parametrize("case", sorted(DURATION_CASES))
def test_duration_step_order_is_bitwise_plain(case):
    name, min_d, max_d, sil, ties = DURATION_CASES[case]
    comp = COMPOSITES[name]()
    if name == "one-state-word":  # duration_arrays rejects it; the trellis takes it
        s = comp.num_states
        min_dur, max_dur, d_cap = np.full(s, 2, np.int32), np.full(s, tvd.UNBOUNDED), 3
    else:
        min_dur, max_dur, d_cap = tvd.duration_arrays(comp, min_d, max_d, sil)
    lengths = np.asarray([16, 9, 2, 16, 1, 6] * (16 if name == "huge-penalty" else 4), np.int32)
    log_b = _log_b(comp, len(case) + 7, lengths, ties)
    want = tvd.viterbi_composite_duration_batch_plain(
        torch.as_tensor(log_b), *_topo(comp), comp.penalty, min_dur, max_dur, lengths,
        d_cap=d_cap)
    ftab, tab = tcs.duration_tables(*_topo(comp), min_dur, max_dur)
    got = emulate_duration(log_b, lengths, ftab, tab, comp.penalty, d_cap)
    finite = _assert_same(got, want)
    assert finite.any() and not finite.all()
    # The dispatcher takes a CPU tensor to the plain version; the wrapper
    # refuses it.
    args = (torch.as_tensor(log_b), *_topo(comp), comp.penalty, min_dur, max_dur, lengths)
    _assert_same(tvd.viterbi_composite_duration_batch(*args, d_cap=d_cap), want)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.duration_decode(*args, d_cap=d_cap)


def sum_tie_problem():
    """Two exits whose best completed values differ (-4.99 at exit 1,
    -3.99 at exit 3) but whose sums with a -3e9 penalty are equal: the
    silence entry's advance at t = 2 takes the lowest exit (the plain
    version's first max over the sums), not the larger value. The only
    finite path: word "1" (0, 1), then silence (4, 5)."""
    log_a = np.full((6, 6), -np.inf, F32)
    for base in (0, 2, 4):
        log_a[base, base: base + 2] = np.log(F32(0.5))
        log_a[base + 1, base + 1] = 0.0
    comp = CompositeHMM(["1", "2", "S"], [2, 2, 2], np.zeros((6, 1), F32),
                        np.ones((6, 1, 1), F32), log_a, -3e9)
    log_b = np.full((1, 4, 6), -np.inf, F32)
    log_b[0, 0, [0, 2]] = 0.0
    log_b[0, 1, [1, 3]] = F32(-3.6), F32(-2.6)
    log_b[0, 2, 4] = log_b[0, 3, 5] = 0.0
    min_dur, max_dur, d_cap = tvd.duration_arrays(comp, 1)
    return comp, log_b, np.asarray([4], np.int32), min_dur, max_dur, d_cap


def test_duration_advance_compares_sums():
    comp, log_b, lengths, min_dur, max_dur, d_cap = sum_tie_problem()
    want = tvd.viterbi_composite_duration_batch_plain(
        torch.as_tensor(log_b), *_topo(comp), comp.penalty, min_dur, max_dur, lengths,
        d_cap=d_cap)
    np.testing.assert_array_equal(np.asarray(want[1])[0, :3], [0, 1, 4])
    ftab, tab = tcs.duration_tables(*_topo(comp), min_dur, max_dur)
    _assert_same(emulate_duration(log_b, lengths, ftab, tab, comp.penalty, d_cap), want)


def entry_exit_problem():
    """A one-state word "2" (state 2, an entry and an exit, at most 2
    frames) whose own exit sum is the best at t = 2 (it sat there at
    t = 0, 1): its entry at t = 2 takes the second-best exit, word "1"'s
    (state 1). The only finite paths: 0, 1, then 2 at t = 2 and 3 (its two
    frames), then silence 3, 4."""
    log_a = np.full((5, 5), -np.inf, F32)
    log_a[0, 0: 2] = np.log(F32(0.5))
    log_a[1, 1] = log_a[2, 2] = log_a[4, 4] = 0.0
    log_a[3, 3: 5] = np.log(F32(0.5))
    comp = CompositeHMM(["1", "2", "S"], [2, 1, 2], np.zeros((5, 1), F32),
                        np.ones((5, 1, 1), F32), log_a, -30.0)
    log_b = np.full((1, 6, 5), -np.inf, F32)
    log_b[0, 0, [0, 2]] = 0.0
    log_b[0, 1, [1, 2]] = F32(-1.0), F32(0.0)
    log_b[0, 2, 2] = log_b[0, 3, 2] = log_b[0, 4, 3] = log_b[0, 5, 4] = 0.0
    min_dur, max_dur = np.ones(5, np.int32), np.full(5, tvd.UNBOUNDED)
    max_dur[2] = 2
    return comp, log_b, np.asarray([6], np.int32), min_dur, max_dur, 2


def test_duration_entry_that_is_an_exit_takes_the_second_best():
    comp, log_b, lengths, min_dur, max_dur, d_cap = entry_exit_problem()
    want = tvd.viterbi_composite_duration_batch_plain(
        torch.as_tensor(log_b), *_topo(comp), comp.penalty, min_dur, max_dur, lengths,
        d_cap=d_cap)
    assert np.isfinite(np.asarray(want[0])).all()
    np.testing.assert_array_equal(np.asarray(want[1])[0], [0, 1, 2, 2, 3, 3])  # the quirk
    ftab, tab = tcs.duration_tables(*_topo(comp), min_dur, max_dur)
    walked = []
    _assert_same(emulate_duration(log_b, lengths, ftab, tab, comp.penalty, d_cap,
                                  walked=walked), want)
    assert (0, 4) in walked  # the second-best exit, on the path


def test_wrappers_refuse_what_the_kernels_do_not_take():
    comp = COMPOSITES["random"]()
    dfa = _grammars(comp.labels)["strings"]
    bad = dfa.next_state.copy()
    bad[0, 0] = len(bad)
    with pytest.raises(ValueError, match="planes outside"):
        tcs.planes_tables(*_topo(comp), comp.word_of_state, bad, dfa.accept)
    word = comp.word_of_state.copy()
    word[0] = len(comp.labels)
    with pytest.raises(ValueError, match="word lies outside"):
        tcs.planes_tables(*_topo(comp), word, dfa.next_state, dfa.accept)
    with pytest.raises(ValueError, match="min_dur"):
        tcs.duration_tables(*_topo(comp), np.ones(3), np.ones(comp.num_states))
    # A CPU tensor never reaches the launch.
    with pytest.raises(ValueError, match="CUDA"):
        tcs._rows(torch.zeros((1, 2, 3)))
