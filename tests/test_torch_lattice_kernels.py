"""The posterior and n-best searches' kernels (csrc/trellis_lattice.cu), held
on the CPU through their plain versions and their step order.

- The plain versions of ops/cuda/trellis_lattice.py against the JAX
  functions they replace, on the same log_b made with numpy from a seed:
  lattice_sum_passes_plain (LSUM) against _sum_passes_batch within rtol
  1e-5 / atol 1e-6 with the same -inf cells; lattice_max_passes_plain
  (LMAX) against _lattice_passes_impl and kbest_forward_plain (KBEST)
  against kbest_composite_forward bitwise (alphas, entry times and every
  backpointer slot). Cases: a 3-word composite, single-state words whose
  self-loop beats the penalty and whose penalty beats the self-loop,
  ragged lengths with a length-2 row, integer-valued log_b for ties, K in
  {1, 4, 6, 16}, T = 1 for LMAX and KBEST.
- LSUM's factorized pools (past 32 exits or entries: one shared pool sum
  a step) on 40-word composites, both kinds of single-state words
  included: all four outputs against JAX with the same -inf cells,
  beta_entry and log Z at RTOL / ATOL, alphas and beta_em at RTOL / ATOL
  of the cell's log-sum-exp magnitude (a cell is lse + log_b, and where the
  emission cancels the lse, float32 rounding of the lse, in JAX's order as
  in any other, exceeds RTOL of the cell); and against the dense order, the
  same -inf cells, the rest within that bound and within 1e-5 * max(1,
  |x|). ``PYTHONPATH=. python tests/test_torch_lattice_kernels.py`` prints the
  readings behind the bound: each output's worst error against JAX, and
  JAX's and the port's against a float64 evaluation of JAX's recurrence, in
  units of RTOL / ATOL of the cell.
- The kernels' step order emulated in numpy float32: KBEST's team branch
  (each state's top K by ranks, the entries' with the duplicate-prefix
  masks as slot < c_j; the pool by ranks over the exit rows' values, its
  -inf tail filled in flat order) at every K bucket, and its simple branch
  (the first design: merges; K past 32, 40 exit rows); LMAX's first design
  (the banded argmax and best exit pool with the lowest index on a tie)
  and its team branch (lmax_team_emulated: band threads and pool warps, the
  best exit by keys from a dense pool's lanes or folded from the warps'
  slots past 32 exits, the carry bits, the backward's entries' max and
  exit rows), signs of zero included: bitwise the plain versions. The
  carry bits (LatticeTopology ints row 3) against JAX's new-instance rule
  for every predecessor a step can pick.
- The dispatchers: CPU tensors run the plain versions and count no launch;
  a CUDA tensor with no kernel library raises, and no plain loop runs.

The kernels themselves run against the plain versions in
tests/test_torch_cuda_kernels.py on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.ops import lattice as jl
from cs304_tpu.ops import nbest as jnb
from cs304_tpu.ops.viterbi import composite_transition_matrix as j_trans
from cs304_tpu_torch.ops.cuda import _build
from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk
from test_torch_viterbi import _composite
from torch_poison import KERNEL_POISONS, differing_cells, plain_run, poisoned
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_lattice.py's

# name: (words, states a word, penalty or None for the composite's -25)
COMPOSITES = {
    "three-words": (3, (3, 4, 2), None),
    "single-state-self-beats": (5, (1, 3), None),  # diag 0 > -25: own cell
    "single-state-pool-beats": (5, (1, 3), 0.0),   # penalty 0 >= diag 0: the pool
    "twelve-words": (12, (5, 5, 3), None),
}
# Past 32 exits (entries) LSUM factorizes its pools.
FACTORIZED = {
    "forty-words": (40, (3, 2), None),
    "forty-single-state-self-beats": (40, (1, 3), None),
    "forty-single-state-pool-beats": (40, (1, 3), 0.0),
}


def _comp(name):
    words, spw, pen = {**COMPOSITES, **FACTORIZED}[name]
    comp = _composite(words, spw)
    if pen is not None:
        comp.penalty = pen
    return comp


def _log_b(rng, shape, ties):
    x = rng.integers(-3, 1, shape) if ties else rng.normal(size=shape) * 3
    return x.astype(np.float32)


def _jax_topology(comp):
    log_a = jnp.asarray(comp.log_a)
    trans = j_trans(log_a, jnp.asarray(comp.lower_of_state), jnp.asarray(comp.is_entry),
                    jnp.asarray(comp.is_exit), comp.penalty)
    diag = jnp.diagonal(log_a)
    return trans, jnp.where(jnp.isfinite(diag), diag, 0.0)


def _topo(comp):
    return tlk.lattice_topology(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                                comp.word_of_state, device="cpu")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _lse_scales(want, log_b, lengths):
    """Each LSUM output's magnitude for RTOL: max(|x|, |lse|) for alphas
    and beta_em, whose cells are lse + log_b (an alphas row frozen at t >=
    length keeps its last live row's), |x| for beta_entry and log Z."""
    alphas, beta_em, beta_entry, log_z = (np.asarray(w, np.float64) for w in want)
    log_b = np.asarray(log_b, np.float64)
    with np.errstate(invalid="ignore"):
        a = np.maximum(np.abs(alphas), np.abs(alphas - log_b))
        for i, n in enumerate(np.asarray(lengths)):
            a[i, n:] = a[i, n - 1]
        b = np.maximum(np.abs(beta_em), np.abs(beta_em - log_b))
    return a, b, np.abs(beta_entry), np.abs(log_z)


def _worst(got, want, scale):
    """The same -inf cells, and the worst |got - want| / (ATOL + RTOL *
    scale) over the finite ones."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    return float((np.abs(got[fin] - want[fin]) / (ATOL + RTOL * scale[fin])).max(initial=0.0))


# -- the plain versions against JAX ---------------------------------------------


@pytest.mark.parametrize("name", sorted(COMPOSITES))
@pytest.mark.parametrize("ties", [False, True])
def test_sum_passes_plain_matches_jax(name, ties):
    comp = _comp(name)
    rng = np.random.default_rng(len(name) + ties)
    lengths = np.array([40, 2, 27, 33], np.int32)  # a length-2 row among ragged ones
    log_b = _log_b(rng, (4, 40, comp.num_states), ties)
    trans, diag_init = _jax_topology(comp)
    want = jax.jit(jl._sum_passes_batch)(
        jnp.asarray(log_b), trans, diag_init, jnp.asarray(comp.is_entry),
        jnp.asarray(comp.is_exit), jnp.asarray(lengths))
    got = tlk.lattice_sum_passes_plain(torch.as_tensor(log_b), _topo(comp), comp.penalty,
                                       torch.as_tensor(lengths))
    for g, w in zip(got, want):  # every row, the garbage ones past length included
        _close(g.numpy(), w)
    assert np.isfinite(np.asarray(want[3])).all()


@pytest.mark.parametrize("poison", KERNEL_POISONS)
def test_plain_passes_on_poisoned_memory_match_jax(poison):
    """LSUM's alphas and beta_em, LMAX's alphas, entry times and beta_em
    and KBEST's backpointer slots are torch.empty allocations in the plain
    versions: on memory filled with a poison they stay JAX's (LSUM within
    RTOL / ATOL, LMAX and KBEST bitwise; rows past a length included), and
    equal those computed on memory filled with another pattern in every
    bit."""
    comp, topo = _comp("twelve-words"), _topo(_comp("twelve-words"))
    rng = np.random.default_rng(26)
    lengths = np.array([40, 2, 27, 33], np.int32)
    lb_sum = _log_b(rng, (4, 40, comp.num_states), False)
    lb_max = _log_b(rng, (30, comp.num_states), True)
    lb_k = _log_b(rng, (25, comp.num_states), False)
    runs = {
        "sum": lambda: tlk.lattice_sum_passes_plain(
            torch.as_tensor(lb_sum), topo, comp.penalty, torch.as_tensor(lengths)),
        "max": lambda: tlk.lattice_max_passes_plain(
            torch.as_tensor(lb_max), topo, comp.penalty, 17),
        "kbest": lambda: tlk.kbest_forward_plain(
            torch.as_tensor(lb_k), topo, comp.penalty, 6, 13),
    }
    with poisoned(poison):
        got = {name: run() for name, run in runs.items()}
    for g, w in zip(got["sum"], _jax_sum_passes(comp, lb_sum, lengths)):
        _close(g.numpy(), w)
    trans, diag_init = _jax_topology(comp)
    want = jl._lattice_passes_impl(
        jnp.asarray(lb_max), trans, diag_init, jnp.asarray(comp.is_entry),
        jnp.asarray(comp.is_exit), jnp.asarray(comp.word_of_state),
        jnp.asarray(comp.lower_of_state),
        jnp.asarray(np.asarray(comp.uppers)[comp.word_of_state]), 17)
    for g, w in zip(got["max"], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jnb.kbest_composite_forward(
        jnp.asarray(lb_k), jnp.asarray(comp.log_a), jnp.asarray(comp.lower_of_state),
        jnp.asarray(comp.is_entry), jnp.asarray(comp.is_exit), comp.penalty, length=13, k=6)
    for g, w in zip(got["kbest"], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name, run in runs.items():
        assert differing_cells(got[name], plain_run(run)) == 0, name


def _factorized_case(name, ties):
    comp = _comp(name)
    assert comp.is_exit.sum() > tlk.DENSE_POOL_MAX
    rng = np.random.default_rng(len(name) + ties)
    lengths = np.array([40, 2, 27, 33], np.int32)
    return comp, _log_b(rng, (4, 40, comp.num_states), ties), lengths


def _jax_sum_passes(comp, log_b, lengths):
    trans, diag_init = _jax_topology(comp)
    return jax.jit(jl._sum_passes_batch)(
        jnp.asarray(log_b), trans, diag_init, jnp.asarray(comp.is_entry),
        jnp.asarray(comp.is_exit), jnp.asarray(lengths))


@pytest.mark.parametrize("name", sorted(FACTORIZED))
@pytest.mark.parametrize("ties", [False, True])
def test_factorized_sum_passes_match_jax(name, ties):
    """Past DENSE_POOL_MAX members, all four outputs against JAX: the same
    -inf cells; beta_entry and log Z at RTOL / ATOL; alphas and beta_em at
    RTOL / ATOL of max(|x|, |lse|) (_lse_scales)."""
    comp, log_b, lengths = _factorized_case(name, ties)
    want = _jax_sum_passes(comp, log_b, lengths)
    got = tlk.lattice_sum_passes_plain(torch.as_tensor(log_b), _topo(comp), comp.penalty,
                                       torch.as_tensor(lengths))
    for g, w, scale in zip(got, want, _lse_scales(want, log_b, lengths)):
        assert _worst(g.numpy(), w, scale) <= 1.0
    _close(got[2].numpy(), want[2])
    _close(got[3].numpy(), want[3])
    assert np.isfinite(np.asarray(want[3])).all()


@pytest.mark.parametrize("name", sorted(FACTORIZED))
@pytest.mark.parametrize("ties", [False, True])
def test_factorized_pools_match_the_dense_order(name, ties, monkeypatch):
    """Past DENSE_POOL_MAX members LSUM shares one pool sum a step (O(W),
    not O(W^2)); against the dense order on the same inputs: the same -inf
    cells, the rest within 1e-5 * max(1, |x|) and within RTOL / ATOL of
    the cell's log-sum-exp magnitude (_lse_scales: two summation orders of
    terms near |lse|, which exceeds the cell where the emission cancels
    it), and log Z against JAX at RTOL / ATOL."""
    comp, log_b_np, lengths_np = _factorized_case(name, ties)
    log_b, lengths = torch.as_tensor(log_b_np), torch.as_tensor(lengths_np)
    got = tlk.lattice_sum_passes_plain(log_b, _topo(comp), comp.penalty, lengths)
    monkeypatch.setattr(tlk, "DENSE_POOL_MAX", 10**6)
    dense = tlk.lattice_sum_passes_plain(log_b, _topo(comp), comp.penalty, lengths)
    for g, d, scale in zip(got, dense, _lse_scales(dense, log_b_np, lengths_np)):
        assert torch.equal(torch.isfinite(g), torch.isfinite(d))
        fin = torch.isfinite(d)
        assert ((g - d)[fin].abs() <= 1e-5 * d[fin].abs().clamp(min=1.0)).all()
        assert _worst(g.numpy(), d.numpy(), scale) <= 1.0
    want = _jax_sum_passes(comp, log_b_np, lengths_np)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(COMPOSITES))
@pytest.mark.parametrize("t,length,ties", [(30, 30, False), (30, 17, True), (2, 2, False),
                                           (1, 1, False)])
def test_max_passes_plain_is_bitwise_jax(name, t, length, ties):
    comp = _comp(name)
    rng = np.random.default_rng(t + length)
    log_b = _log_b(rng, (t, comp.num_states), ties)
    trans, diag_init = _jax_topology(comp)
    upper = np.asarray(comp.uppers)[comp.word_of_state]
    want = jl._lattice_passes_impl(
        jnp.asarray(log_b), trans, diag_init, jnp.asarray(comp.is_entry),
        jnp.asarray(comp.is_exit), jnp.asarray(comp.word_of_state),
        jnp.asarray(comp.lower_of_state), jnp.asarray(upper), length)
    got = tlk.lattice_max_passes_plain(torch.as_tensor(log_b), _topo(comp), comp.penalty,
                                       length)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert t == 1 or np.isfinite(np.asarray(want[3]))  # at T = 1 only entries are live


@pytest.mark.parametrize("name", sorted(COMPOSITES))
@pytest.mark.parametrize("k", [1, 4, 6, 16])
def test_kbest_plain_is_bitwise_jax(name, k):
    comp = _comp(name)
    rng = np.random.default_rng(k)
    ties = k in (4, 16)
    for t, length in ((25, None), (25, 13), (1, None)):
        log_b = _log_b(rng, (t, comp.num_states), ties)
        want = jnb.kbest_composite_forward(
            jnp.asarray(log_b), jnp.asarray(comp.log_a), jnp.asarray(comp.lower_of_state),
            jnp.asarray(comp.is_entry), jnp.asarray(comp.is_exit), comp.penalty,
            length=length, k=k)
        got = tlk.kbest_forward_plain(torch.as_tensor(log_b), _topo(comp), comp.penalty, k,
                                      length)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# -- the kernels' step order emulated in numpy ---------------------------------


def _threads(s):
    return min(1024, 32 * -(-s // 32))


def _bucket(k):
    """KBEST's K bucket (csrc/trellis_lattice.cu kbest_bucket)."""
    return next(b for b in (1, 2, 4, 8, 16, 32) if k <= b)


def _lift(pred, lim, step):
    """The kernels' binary search from the given first step: the length of
    the prefix of [0, lim) where pred holds (pred true then false), up to
    2 step - 1."""
    lo = 0
    while step:
        if lo + step - 1 < lim and pred(lo + step - 1):
            lo += step
        step >>= 1
    return lo


def _beats(v, f, w, g):
    """(v, f) before (w, g): the larger value, the lower key on a tie."""
    return v > w or (v == w and f < g)


def kbest_emulated(log_b, comp, k, length=None):
    """KBEST's team branch as csrc/trellis_lattice.cu runs a step, in numpy
    float32: (alpha (S, K), bps (T, S, K)). A state's stable top K by ranks:
    a non-entry's 3K candidates each count the values of the other two
    sorted blocks that beat it (value desc, block asc, slot asc); an
    entry's pool and self-loop candidates count by binary searches in the
    unmasked sorted lists and by the masks' bits (value desc, the pool
    first, index asc); the pool by ranks too: each finite value of an exit
    row (past 32 exits, of the K best-headed rows, a row whose head ranks h
    its first K - h values) counts the values of the other rows that beat
    it (binary searches), its -inf tail the lowest flat indices at -inf.
    Keys are x * KB + slot."""
    t_total, s = log_b.shape
    length = t_total if length is None else length
    kb = _bucket(k)
    coefs = _topo(comp).coefs.numpy()
    c0, c1, c2, de, entry, exit_, dinit = coefs[:7]
    entry, exit_ = entry > 0, exit_ > 0
    pen = np.float32(comp.penalty)
    exits = np.flatnonzero(exit_)
    neg = np.float32(-np.inf)
    cur = np.full((s, k), neg, np.float32)
    cur[:, 0] = np.where(entry, log_b[0] + dinit, neg)
    fcnt = (cur != neg).sum(1)
    bps = np.full((t_total, s, k), -1, np.int64)

    def count(arr, v, ge):
        """team_counts: arr non-increasing over the team's KB lanes, its
        surplus lanes (slots past K) at -inf; the steps KB/2 .. 1, then the
        last lane."""
        a = np.full(kb, neg, np.float32)
        a[:k] = arr
        pred = (lambda i: a[i] >= v) if ge else (lambda i: a[i] > v)
        lo = _lift(pred, kb - 1, kb // 2) if kb > 1 else 0
        return kb if lo == kb - 1 and pred(kb - 1) else lo

    for t in range(1, t_total):
        # The pool: each finite (row r, slot m) of the rows ranks itself by m
        # and the values of the other rows beating it (a lower state on a
        # tie). Past 32 exits the rows are the K best-headed ones, ranked
        # first (a lower state on a tie), and a row whose head ranks h
        # offers its first K - h values.
        rows = list(exits)
        if len(exits) > 32:
            hv = [cur[x, 0] if fcnt[x] else neg for x in exits]
            rank = [sum(hw > h or (hw == h and v < u) for v, hw in enumerate(hv))
                    for u, h in enumerate(hv)]
            rows = [None] * k
            for u, x in enumerate(exits):
                if hv[u] != neg and rank[u] < k:
                    rows[rank[u]] = x
            rows = [x for x in rows if x is not None]
        pool = [None] * k
        for r, x in enumerate(rows):
            for m in range(min(k - r if len(exits) > 32 else k, fcnt[x])):
                v = cur[x, m]
                q = m + sum(_lift(lambda i, x2=x2: cur[x2, i] > v
                                  or (x2 < x and cur[x2, i] == v), fcnt[x2], kb)
                            for x2 in rows if x2 != x)
                # (_lift from step KB reaches 2 KB - 1 >= fcnt: the whole row)
                if q < k:
                    assert pool[q] is None
                    pool[q] = (v, x * kb + m)
        nfin = min(k, int(fcnt[rows].sum()))
        assert all(p is not None for p in pool[:nfin])
        pool = pool[:nfin]
        for sx in range(s):  # the -inf tail
            first = int(fcnt[sx]) if exit_[sx] else 0
            for slot in range(first, k):
                if len(pool) < k:
                    pool.append((neg, sx * kb + slot))
        pv = np.asarray([v for v, _f in pool], np.float32)
        ps = [f // kb for _v, f in pool]
        pm = [f % kb for _v, f in pool]
        new = np.empty_like(cur)
        new_f = np.empty_like(fcnt)
        for j in range(s):
            vals, codes = [None] * k, [None] * k
            cands = []  # (rank, value, code)
            if not entry[j]:
                b = [(cur[j - 2] if j >= 2 else np.full(k, neg, np.float32)) + c2[j],
                     (cur[j - 1] if j >= 1 else np.full(k, neg, np.float32)) + c1[j],
                     cur[j] + c0[j]]
                preds = [max(j - 2, 0), max(j - 1, 0), j]
                for blk in range(3):
                    for r in range(k):
                        v = b[blk][r]
                        q = r + sum(count(b[o], v, ge=o < blk) for o in range(3) if o != blk)
                        cands.append((q, v, preds[blk] * k + r))
            else:
                both, beats = exit_[j], pen >= de[j]
                pco = pv + pen
                sco = cur[j] + de[j]
                cj = sum(both and ps[r] == j for r in range(k))
                pmask = [both and not beats and ps[r] == j for r in range(k)]
                smask = [both and beats and r < cj for r in range(k)]
                pc = np.where(pmask, neg, pco).astype(np.float32)
                sc = np.where(smask, neg, sco).astype(np.float32)
                pf = [pc[r] != neg for r in range(k)]
                sf = [sc[r] != neg for r in range(k)]
                fin = sum(pf) + sum(sf)
                m0 = cj if both and beats else 0
                for r in range(k):
                    if pf[r]:
                        qp = sum(pf[:r]) + max(count(sco, pc[r], False) - m0, 0)
                    else:
                        qp = fin + sum(not x for x in pf[:r])
                    cands.append((qp, pc[r], ps[r] * k + pm[r]))
                    if sf[r]:
                        cge = count(pco, sc[r], True)
                        qs = cge - sum(pmask[:cge]) + sum(sf[:r])
                    else:
                        qs = fin + (k - sum(pf)) + sum(not x for x in sf[:r])
                    cands.append((qs, sc[r], j * k + r))
            for q, v, code in cands:
                if q < k:
                    assert vals[q] is None
                    vals[q], codes[q] = v, code
            bps[t, j] = codes
            new[j] = np.asarray(vals, np.float32) + log_b[t, j]
            new_f[j] = (new[j] != neg).sum()
        if t < length:
            cur, fcnt = new, new_f
    return cur, bps


@pytest.mark.parametrize("name", ["single-state-pool-beats", "single-state-self-beats",
                                  "three-words", "twelve-words", "forty-words",
                                  "forty-single-state-pool-beats"])
@pytest.mark.parametrize("k,ties", [(1, True), (4, True), (6, False), (8, True), (16, True),
                                    (32, False)])
def test_kbest_kernel_order_is_bitwise_plain(name, k, ties):
    """The team branch's step (kbest_emulated) bitwise kbest_forward_plain:
    every K bucket, single-state words under both penalty cases, integer
    ties, up to 32 exit rows and past them (40 words: the heads ranked
    first)."""
    comp = _comp(name)
    rng = np.random.default_rng(31 + k)
    log_b = _log_b(rng, (14 if comp.num_states < 100 else 8, comp.num_states), ties)
    want = tlk.kbest_forward_plain(torch.as_tensor(log_b), _topo(comp), comp.penalty, k, 9)
    got = kbest_emulated(log_b, comp, k, 9)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("name", ["single-state-pool-beats", "single-state-self-beats",
                                  "three-words", "forty-single-state-pool-beats",
                                  "forty-words"])
@pytest.mark.parametrize("k,ties", [(1, True), (4, True), (6, False), (16, True), (33, False)])
def test_kbest_simple_branch_order_is_bitwise_plain(name, k, ties):
    """The simple branch's step (kbest_simple_emulated, the first design,
    which takes K past 32 and exit rows past 32) bitwise
    kbest_forward_plain."""
    comp = _comp(name)
    rng = np.random.default_rng(31 + k)
    log_b = _log_b(rng, (14 if comp.num_states < 100 else 8, comp.num_states), ties)
    want = tlk.kbest_forward_plain(torch.as_tensor(log_b), _topo(comp), comp.penalty, k, 9)
    got = kbest_simple_emulated(log_b, comp, k, 9)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def kbest_simple_emulated(log_b, comp, k, length=None):
    """KBEST's simple branch (the first design) as csrc/trellis_lattice.cu
    runs a step, in numpy float32: (alpha (S, K), bps (T, S, K)). The pool
    as a merge of the warps' merges of sorted exit rows with its -inf tail
    filled in flat order; each state's three-block or two-list merge with
    the duplicate-prefix masks as slot < c_j."""
    t_total, s = log_b.shape
    length = t_total if length is None else length
    coefs = _topo(comp).coefs.numpy()
    c0, c1, c2, de, entry, exit_, dinit = coefs[:7]
    entry, exit_ = entry > 0, exit_ > 0
    pen = np.float32(comp.penalty)
    exits = np.flatnonzero(exit_)
    nt = _threads(s)
    neg = np.float32(-np.inf)
    cur = np.full((s, k), neg, np.float32)
    cur[:, 0] = np.where(entry, log_b[0] + dinit, neg)
    bps = np.full((t_total, s, k), -1, np.int64)

    def merge(lists):  # each list [(value, flat)] sorted by (value desc, flat asc)
        heads = [0] * len(lists)
        out = []
        while len(out) < k:
            best = None
            for w, lst in enumerate(lists):
                if heads[w] < len(lst):
                    v, f = lst[heads[w]]
                    if best is None or v > best[0] or (v == best[0] and f < best[1]):
                        best = (v, f, w)
            if best is None:
                break
            out.append(best[:2])
            heads[best[2]] += 1
        return out

    for t in range(1, t_total):
        warps = {}
        for i, x in enumerate(exits):  # a thread's rows: ordinals tid + r nt
            row = [(cur[x, r], x * k + r) for r in range(k) if cur[x, r] != neg]
            warps.setdefault((i % nt) // 32, []).append(row)
        pool = merge([merge(rows) for _w, rows in sorted(warps.items())])
        for sx in range(s):  # the -inf tail: the lowest flat indices at -inf
            first = int(np.sum(cur[sx] != neg)) if exit_[sx] else 0
            for slot in range(first, k):
                if len(pool) < k:
                    pool.append((neg, sx * k + slot))
        new = np.empty_like(cur)
        for j in range(s):
            vals, codes = [], []
            if not entry[j]:
                blocks = [(cur[j - 2] if j >= 2 else np.full(k, neg, np.float32)) + c2[j],
                          (cur[j - 1] if j >= 1 else np.full(k, neg, np.float32)) + c1[j],
                          cur[j] + c0[j]]
                preds = [max(j - 2, 0), max(j - 1, 0), j]
                h = [0, 0, 0]
                for _q in range(k):
                    b = 0
                    for bb in (1, 2):
                        if blocks[bb][h[bb]] > blocks[b][h[b]]:
                            b = bb
                    vals.append(blocks[b][h[b]])
                    codes.append(preds[b] * k + h[b])
                    h[b] += 1
            else:
                both = exit_[j]
                beats = pen >= de[j]
                cj = sum(f // k == j for _v, f in pool) if both else 0
                a = [neg if (both and not beats and f // k == j) else np.float32(v + pen)
                     for v, f in pool]
                b = [neg if (both and beats and i < cj) else cur[j, i] + de[j]
                     for i in range(k)]
                fa = [i for i in range(k) if a[i] != neg]
                fb = [i for i in range(k) if b[i] != neg]
                while len(vals) < k and (fa or fb):
                    if fa and (not fb or a[fa[0]] >= b[fb[0]]):
                        i = fa.pop(0)
                        vals.append(a[i])
                        codes.append(pool[i][1])
                    else:
                        i = fb.pop(0)
                        vals.append(b[i])
                        codes.append(j * k + i)
                tail = ([(neg, pool[i][1]) for i in range(k) if a[i] == neg]
                        + [(neg, j * k + i) for i in range(k) if b[i] == neg])
                for v, c in tail[: k - len(vals)]:
                    vals.append(v)
                    codes.append(c)
            bps[t, j] = codes
            new[j] = np.asarray(vals, np.float32) + log_b[t, j]
        if t < length:
            cur = new
    return cur, bps


def lmax_forward_emulated(log_b, comp, length):
    """LMAX's forward as csrc/trellis_lattice.cu runs it, in numpy float32:
    the band's first max, an entry's own cell against the best exit by
    (alpha + penalty, lowest index), 0 for an all -inf column."""
    t_total, s = log_b.shape
    coefs = _topo(comp).coefs.numpy()
    c0, c1, c2, de, entry, exit_, dinit = coefs[:7]
    entry, exit_ = entry > 0, exit_ > 0
    pen = np.float32(comp.penalty)
    neg = np.float32(-np.inf)
    own_cell = np.where(entry, np.maximum(np.where(exit_, pen, neg), de), neg)
    word, lower = comp.word_of_state, comp.lower_of_state
    upper = np.asarray(comp.uppers)[word]
    alpha = np.where(entry, log_b[0] + dinit, neg).astype(np.float32)
    et = np.zeros(s, np.int64)
    alphas, ets = [alpha], [et]
    for t in range(1, t_total):
        if t < length:
            u = [(alpha[x] + pen, x) for x in np.flatnonzero(exit_)]
            pv, pi = max(u, key=lambda p: (p[0], -p[1]))
            new, new_et = np.empty_like(alpha), np.empty_like(et)
            for j in range(s):
                if not entry[j]:
                    v, p = neg, 0
                    if j >= 2:
                        v, p = alpha[j - 2] + c2[j], j - 2
                    if j >= 1 and alpha[j - 1] + c1[j] > v:
                        v, p = alpha[j - 1] + c1[j], j - 1
                    if alpha[j] + c0[j] > v:
                        v, p = alpha[j] + c0[j], j
                else:
                    v, p = pv, pi
                    own = alpha[j] + own_cell[j]
                    if own > v or (own == v and j < p):
                        v, p = own, j
                if v == neg:
                    p = 0
                fresh = p != j and (word[p] != word[j] or (p == upper[j] and j == lower[j]))
                new[j], new_et[j] = v + log_b[t, j], t if fresh else et[p]
            alpha, et = new, new_et
        alphas.append(alpha)
        ets.append(et)
    return np.stack(alphas), np.stack(ets)


@pytest.mark.parametrize("name", sorted(COMPOSITES))
@pytest.mark.parametrize("ties", [False, True])
def test_lmax_kernel_order_is_bitwise_plain(name, ties):
    comp = _comp(name)
    rng = np.random.default_rng(7 + ties)
    log_b = _log_b(rng, (24, comp.num_states), ties)
    want = tlk.lattice_max_passes_plain(torch.as_tensor(log_b), _topo(comp), comp.penalty, 19)
    alphas, ets = lmax_forward_emulated(log_b, comp, 19)
    np.testing.assert_array_equal(alphas, want[0].numpy())
    np.testing.assert_array_equal(ets, want[1].numpy())


INT_MAX, INT_MIN = 2**31 - 1, -2**31


def _lmax_plan(s, n_x, n_e, ks=None, cluster=False):
    """csrc/trellis_lattice.cu max_plan on one CTA: (states a band thread,
    band threads, pool warps, dense pool, cells a pool lane); ks pins the
    band's states a thread. cluster: the step order of a cluster plan (4
    states a band thread, the pool folded from the warps' slots even where
    it is dense); a cluster's CTAs share the states, and its fold by keys
    over every CTA's warps picks what one CTA's fold does."""
    dense = n_x <= 32 and n_e <= 32 and not cluster
    npw = 1 if n_x <= 32 and n_e <= 32 else min(-(-max(n_x, n_e) // 32), 8)
    need = -(-max(n_x, n_e) // (32 * npw))
    cpl = next(c for c in (1, 2, 4, 8) if need <= c)
    for k in (1, 2, 4) if ks is None and not cluster else (4 if cluster else ks,):
        band = 32 * -(-(-(-s // k)) // 32)
        if ks is not None or cluster or band + 32 * npw <= 1024:
            return k, band, npw, dense, cpl
    raise AssertionError("no one-CTA plan")


def _f32_bits(v):
    return int(np.array(v, np.float32).view(np.int32))


def _tie_key(v):
    """tie_key: the order-preserving int key of a float32, -0 as +0."""
    b = _f32_bits(0.0 if v == 0 else v)
    return b if b >= 0 else b ^ 0x7FFFFFFF


def _keyed_best(lanes):
    """warp_best_keyed over a warp's (value, index) lanes (index INT_MAX:
    none): the largest key, the lowest index at it, the value read from
    the winner's lane (the ballot's first)."""
    keys = [INT_MIN if i == INT_MAX else _tie_key(v) for v, i in lanes]
    m = max(keys)
    bi = min([i for (_v, i), k in zip(lanes, keys) if i != INT_MAX and k == m], default=INT_MAX)
    return next(v for v, i in lanes if i == bi), bi


def _ordered_best(lanes):
    """warp_best_ordered, where the lanes' indices ascend: the first lane at
    the largest key."""
    keys = [INT_MIN if i == INT_MAX else _tie_key(v) for v, i in lanes]
    return lanes[keys.index(max(keys))]


def _redux_max(values):
    """warp_max_redux: the max by order-preserving keys (-0 below +0)."""
    keys = [(b if b >= 0 else b ^ 0x7FFFFFFF) for b in map(_f32_bits, values)]
    k = max(keys)
    return np.array(k if k >= 0 else k ^ 0x7FFFFFFF, np.int32).view(np.float32)[()]


def _fmax(a, b):
    return b if b > a else a


def _better(v, i, bv, bi):
    return v > bv or (v == bv and i < bi)


def lmax_team_emulated(log_b, comp, length, ks=None, cluster=False):
    """LMAX's team branch (csrc/trellis_lattice.cu max_team_forward and
    max_team_backward) in numpy float32, thread by thread and warp by warp:
    band threads holding the non-entries (the forward) or non-exit rows (the
    backward) j = tid + k band, pool warps holding the entry columns (exit
    rows) pw 32 + l + c 32 npw. Forward: a band cell's first max over (j-2,
    j-1, j) with its entry time t or the pick's own by the carry bits
    (ints row 3), state 0's where the column is all -inf; the previous
    row's best exit by keys (largest value with -0 as +0, lowest index, the
    value read back from the winner), from the exits' lanes (dense: the
    first lane at the largest key, the lanes' indices ascending) or folded
    from each warp's partial (factorized: each lane's exits in order, then
    the warp's best, the first lane's at one state or cell a lane, else the
    lowest index at the key, in a slot a warp; always on a cluster); an
    entry's own cell against it (the lowest index on a tie), a pool pick
    other than the entry itself with entry time t. Backward: the entries'
    max (beta_entry) by keys, from the entries' lanes or folded from each
    warp's partial max; a row's
    max(max(t0, t1), t2), an exit's with penalty + that max. Returns
    (alphas, ets, beta_entry, score)."""
    topo = _topo(comp)
    coefs, bits = topo.coefs.numpy(), topo.ints.numpy()[3]
    c0, c1, c2, de, entry, exit_, dinit = coefs[:7]
    entry, exit_ = entry > 0, exit_ > 0
    exits, entries = np.flatnonzero(exit_), np.flatnonzero(entry)
    t_total, s = log_b.shape
    ks, nb, npw, dense, cpl = _lmax_plan(s, len(exits), len(entries), ks, cluster)
    nw = nb // 32 + npw
    pen, neg = np.float32(comp.penalty), np.float32(-np.inf)
    own_cell = np.where(entry, np.maximum(np.where(exit_, pen, neg), de), neg).astype(np.float32)

    def holders(band_states, pool_states):
        """Each thread's states, ascending: band tid's j = tid + k nb with
        band_states[j], pool lane (pw, l)'s pool_states[pw 32 + l + c 32 npw]."""
        out = [[j for j in range(tid, min(s, tid + ks * nb), nb) if band_states[j]]
               for tid in range(nb)]
        return out + [list(pool_states[pw * 32 + lane:: 32 * npw])
                      for pw in range(npw) for lane in range(32)]

    def warps(per_thread):
        return [per_thread[32 * w: 32 * w + 32] for w in range(nw)]

    # Forward.
    fwd = holders(~entry, entries)
    alpha = np.where(entry, log_b[0] + dinit, neg).astype(np.float32)
    et = np.zeros(s, np.int64)
    alphas, ets = [alpha], [et]
    for t in range(1, t_total):
        if t < min(length, t_total):
            if dense:  # lane i holds exit i: ordered
                lanes = [(alpha[x] + pen, int(x)) for x in exits]
                pv, pi = _ordered_best(lanes + [(neg, INT_MAX)] * (32 - len(lanes)))
            else:
                # Each warp's best of the row in a slot (one state or cell a
                # lane: ordered), folded by keys.
                slots = []
                for w, warp in enumerate(warps(fwd)):
                    part = []
                    for states in warp:
                        bv, bi = neg, INT_MAX
                        for j in states:
                            if exit_[j] and _better(alpha[j] + pen, j, bv, bi):
                                bv, bi = alpha[j] + pen, j
                        part.append((bv, bi))
                    ordered = ks == 1 if w < nb // 32 else cpl == 1
                    slots.append((_ordered_best if ordered else _keyed_best)(part))
                pv, pi = _keyed_best(slots + [(neg, INT_MAX)] * (32 - len(slots)))
            new, new_et = alpha.copy(), et.copy()
            for j in range(s):
                b = bits[j]
                if not entry[j]:
                    v = alpha[j - 2] + c2[j] if j >= 2 else neg
                    e = t if b & tlk.NEW_SUB2 else (et[j - 2] if j >= 2 else 0)
                    v1 = (alpha[j - 1] if j >= 1 else neg) + c1[j]
                    if v1 > v:
                        v, e = v1, (t if b & tlk.NEW_SUB1 else et[j - 1])
                    if alpha[j] + c0[j] > v:
                        v, e = alpha[j] + c0[j], et[j]
                else:
                    own = alpha[j] + own_cell[j]
                    if _better(own, j, pv, pi):
                        v, e = own, et[j]
                    else:
                        v, e = pv, (et[j] if pi == j else t)
                if v == neg:
                    e = t if b & tlk.NEW_FROM0 else et[0]
                new[j], new_et[j] = v + log_b[t, j], e
            alpha, et = new, new_et
        alphas.append(alpha)
        ets.append(et)
    score = neg
    for x in exits:
        score = _fmax(score, alpha[x])

    # Backward.
    bwd = holders(~exit_, exits)
    q0 = np.where(entry, own_cell, c0)
    q1 = np.append(c1[1:], np.float32(0))
    q2 = np.append(c2[2:], np.float32([0, 0]))[:s]
    terminal = np.where(exit_, np.float32(0), neg).astype(np.float32)
    beta = terminal
    beta_entry = np.empty(t_total, np.float32)
    for t in range(t_total - 1, -1, -1):
        bem = (log_b[t] + (terminal if 1 <= t == length - 1 else beta)).astype(np.float32)
        if dense:
            bq = _redux_max([bem[e] for e in entries] + [neg] * (32 - len(entries)))
        else:
            slots = []
            for warp in warps(bwd):
                part = []
                for states in warp:
                    mx = neg
                    for j in states:
                        if entry[j]:
                            mx = _fmax(mx, bem[j])
                    part.append(mx)
                slots.append(_redux_max(part))
            bq = _redux_max(slots + [neg] * (32 - len(slots)))
        beta_entry[t] = bq
        if t == 0:
            break
        beta = np.empty(s, np.float32)
        for j in range(s):
            t1 = q1[j] + bem[j + 1] if j + 1 < s else neg
            t2 = q2[j] + bem[j + 2] if j + 2 < s else neg
            beta[j] = _fmax(_fmax(q0[j] + bem[j], t1), t2)
            if exit_[j]:
                beta[j] = _fmax(beta[j], bq + pen)
    return np.stack(alphas), np.stack(ets), beta_entry, score


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.array_equal(got, want) and np.array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("name", sorted({**COMPOSITES, **FACTORIZED}))
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("ks", [None, 4, "cluster"])
def test_lmax_team_order_is_bitwise_plain(name, ties, ks):
    """The team branch's step order (lmax_team_emulated, the plan's states
    a band thread, 4, or a cluster plan's order: 4 and the pool always
    folded from the warps' slots) bitwise lattice_max_passes_plain, signs
    of zero included: alphas, entry times, beta_entry and score at a length
    below T, at the full length and at T = 1; a dense pool up to 32 exits,
    the warps' partial folds past them (the 40-word composites)."""
    comp = _comp(name)
    rng = np.random.default_rng(11 + ties)
    for t, length in ((24, 17), (24, 24), (1, 1)):
        log_b = _log_b(rng, (t, comp.num_states), ties)
        want = tlk.lattice_max_passes_plain(torch.as_tensor(log_b), _topo(comp), comp.penalty,
                                            length)
        got = lmax_team_emulated(log_b, comp, length, None if ks == "cluster" else ks,
                                 cluster=ks == "cluster")
        for g, w in zip(got, want):
            assert _bits_equal(g, w.numpy()), (t, length)
        assert t == 1 or np.isfinite(got[3])


@pytest.mark.parametrize("name", sorted({**COMPOSITES, **FACTORIZED}))
def test_carry_bits_are_jax_new_instance_rule(name):
    """ints row 3 (carry_bits) against JAX's new_inst expression
    (cs304_tpu/ops/lattice.py:263-266, evaluated by jnp on a column of
    picks) for every predecessor each state's forward step can pick: j-2
    and j-1 (a non-entry's band), state 0 (an all -inf column) and, for an
    entry, every exit but itself (no bit: the team branch takes t for such
    a pick, and the rule marks each of them new on these composites)."""
    comp = _comp(name)
    bits = _topo(comp).ints.numpy()[3]
    s = comp.num_states
    word_of = jnp.asarray(comp.word_of_state)
    lower_of_state = jnp.asarray(comp.lower_of_state)
    upper_of_state = jnp.asarray(np.asarray(comp.uppers)[comp.word_of_state])
    sidx = jnp.arange(s, dtype=jnp.int32)

    def jax_rule(bp):
        bp = jnp.asarray(bp, jnp.int32)
        new_inst = (bp != sidx) & (
            (word_of[bp] != word_of)
            | ((bp == upper_of_state) & (sidx == lower_of_state))
        )
        return np.asarray(new_inst)

    j = np.arange(s)
    non_entry = ~np.asarray(comp.is_entry)
    for back, bit in ((2, tlk.NEW_SUB2), (1, tlk.NEW_SUB1)):
        can = non_entry & (j >= back)
        rule = jax_rule(np.maximum(j - back, 0))
        np.testing.assert_array_equal((bits & bit != 0)[can], rule[can])
    np.testing.assert_array_equal(bits & tlk.NEW_FROM0 != 0, jax_rule(np.zeros(s)))
    entries = np.flatnonzero(comp.is_entry)
    pool_new = np.ones(s, bool)
    for x in np.flatnonzero(comp.is_exit):
        pool_new &= jax_rule(np.full(s, x)) | (j == x)
    assert pool_new[entries].all()
    assert not (bits & ~(tlk.NEW_SUB2 | tlk.NEW_SUB1 | tlk.NEW_FROM0)).any()


@pytest.mark.parametrize("where", ["exit-inside-a-word", "entry-inside-a-word"])
def test_topology_whose_pool_pick_continues_a_word_raises(where):
    """lattice_topology refuses a topology where an entry's pool pick (an
    exit of its own word) would continue the word instance by JAX's rule:
    an exit before its word's last state, or an entry after its word's
    first. The team branch takes t for every pool pick but the entry
    itself."""
    comp = _comp("three-words")
    is_entry, is_exit = np.array(comp.is_entry), np.array(comp.is_exit)
    lower = np.asarray(comp.lower_of_state)
    word = np.asarray(comp.word_of_state)
    w = int(np.argmax(np.bincount(word)))  # the longest word
    first = int(np.flatnonzero(word == w)[0])
    if where == "exit-inside-a-word":
        is_exit[first + 1] = True
    else:
        is_entry[first + 1] = True
    # The unchanged topology is taken.
    tlk.lattice_topology(comp.log_a, lower, comp.is_entry, comp.is_exit, word)
    with pytest.raises(ValueError, match="continue the word instance"):
        tlk.lattice_topology(comp.log_a, lower, is_entry, is_exit, word)


# -- dispatch -------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    comp = _comp("three-words")
    topo = _topo(comp)
    log_b = torch.as_tensor(_log_b(np.random.default_rng(0), (2, 9, comp.num_states), False))
    lengths = torch.tensor([9, 5], dtype=torch.int32)
    counters = (tlk.lattice_sum_passes, tlk.lattice_max_passes, tlk.kbest_forward)
    before = [c.launches for c in counters]
    got = tlk.lattice_sum_passes(log_b, topo, comp.penalty, lengths)
    want = tlk.lattice_sum_passes_plain(log_b, topo, comp.penalty, lengths)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = tlk.lattice_max_passes(log_b[0], topo, comp.penalty, 9)
    want = tlk.lattice_max_passes_plain(log_b[0], topo, comp.penalty, 9)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = tlk.kbest_forward(log_b[0], topo, comp.penalty, 4)
    want = tlk.kbest_forward_plain(log_b[0], topo, comp.penalty, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [c.launches for c in counters] == before


class _OnCard:
    """A stand-in for a CUDA tensor on a host without a card: what the
    dispatchers read of one."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t
        self.shape, self.dtype = t.shape, t.dtype

    def is_contiguous(self):
        return True

    def numel(self):
        return self._t.numel()

    def contiguous(self):
        return self


def test_a_cuda_tensor_without_kernels_raises(monkeypatch):
    comp = _comp("three-words")
    topo = _topo(comp)
    card = tlk.LatticeTopology(*(_OnCard(x) for x in (topo.coefs, topo.ints, topo.exits,
                                                      topo.entries)))
    log_b = _OnCard(torch.zeros((2, 9, comp.num_states)))
    lengths = _OnCard(torch.ones(2, dtype=torch.int32))

    def no_library():
        raise RuntimeError("no kernel library")

    def no_plain(*_a, **_k):
        raise AssertionError("a plain loop ran on a CUDA tensor")

    monkeypatch.setattr(_build, "load", no_library)
    for name in ("lattice_sum_passes_plain", "lattice_max_passes_plain",
                 "kbest_forward_plain"):
        monkeypatch.setattr(tlk, name, no_plain)
    counters = (tlk.lattice_sum_passes, tlk.lattice_max_passes, tlk.kbest_forward)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match="no kernel library"):
        tlk.lattice_sum_passes(log_b, card, comp.penalty, lengths)
    one = _OnCard(torch.zeros((9, comp.num_states)))
    with pytest.raises(RuntimeError, match="no kernel library"):
        tlk.lattice_max_passes(one, card, comp.penalty, 9)
    with pytest.raises(RuntimeError, match="no kernel library"):
        tlk.kbest_forward(one, card, comp.penalty, 4)
    assert [c.launches for c in counters] == before
    s_big = tlk.MAX_LATTICE_STATES + 1
    wide = tlk.LatticeTopology(_OnCard(torch.zeros((8, s_big))),
                               _OnCard(torch.zeros((3, s_big), dtype=torch.int32)),
                               *(_OnCard(torch.zeros(1, dtype=torch.int32)) for _ in range(2)))
    with pytest.raises(ValueError, match=str(tlk.MAX_LATTICE_STATES)):
        tlk.lattice_max_passes(_OnCard(torch.zeros((1, s_big))), wide, 0.0, 1)


# -- the readings behind LSUM's bound ---------------------------------------------


def _sum_passes_f64(comp, log_b, lengths):
    """JAX's _sum_passes_masked recurrence on the dense matrix in numpy
    float64: (alphas, beta_em, beta_entry, log_z)."""
    trans, diag_init = (np.asarray(x, np.float64) for x in _jax_topology(comp))
    entry, exit_ = np.asarray(comp.is_entry), np.asarray(comp.is_exit)
    lse = np.logaddexp.reduce
    log_b = log_b.astype(np.float64)
    b, t_total, s = log_b.shape
    alphas, beta_em = np.empty((b, t_total, s)), np.empty((b, t_total, s))
    for i, n in enumerate(lengths):
        alpha = np.where(entry, log_b[i, 0] + diag_init, -np.inf)
        alphas[i, 0] = alpha
        for t in range(1, t_total):
            if t < n:
                alpha = lse(alpha[:, None] + trans, axis=0) + log_b[i, t]
            alphas[i, t] = alpha
        terminal = np.where(exit_, 0.0, -np.inf)
        beta = terminal
        for t in range(t_total - 1, 0, -1):
            beta_em[i, t] = log_b[i, t] + (terminal if t == n - 1 else beta)
            beta = lse(trans + beta_em[i, t][None, :], axis=1)
        beta_em[i, 0] = log_b[i, 0] + beta
    beta_entry = lse(np.where(entry, beta_em, -np.inf), axis=2)
    log_z = lse(np.where(exit_, alphas[np.arange(b), -1], -np.inf), axis=1)
    return alphas, beta_em, beta_entry, log_z


def readings():
    """Print, for each factorized case and output, the worst error in units
    of RTOL / ATOL: the port's plain version against JAX on |x| and on
    _lse_scales, and JAX's and the port's against float64 on |x|."""
    outputs = ("alphas", "beta_em", "beta_entry", "log_z")
    for name in sorted(FACTORIZED):
        for ties in (False, True):
            comp, log_b, lengths = _factorized_case(name, ties)
            want = [np.asarray(w) for w in _jax_sum_passes(comp, log_b, lengths)]
            got = [g.numpy() for g in tlk.lattice_sum_passes_plain(
                torch.as_tensor(log_b), _topo(comp), comp.penalty, torch.as_tensor(lengths))]
            exact = _sum_passes_f64(comp, log_b, lengths)
            for k, scale in enumerate(_lse_scales(want, log_b, lengths)):
                plain = np.abs(want[k])
                print(f"{name} ties={ties} {outputs[k]}: cells {np.isfinite(want[k]).sum()}, "
                      f"port-JAX {_worst(got[k], want[k], plain):.3f} "
                      f"(lse {_worst(got[k], want[k], scale):.3f}), "
                      f"JAX-f64 {_worst(want[k], exact[k], np.abs(exact[k])):.3f}, "
                      f"port-f64 {_worst(got[k], exact[k], np.abs(exact[k])):.3f}")


if __name__ == "__main__":
    readings()
