"""Two orderings of the team kernel's reductions (csrc/trellis_scanfree.cu),
emulated in torch on the CPU and held bitwise against the plain version and
the JAX package.

The BEAM decode mode's deferred prune: the kernel carries each step's
UNPRUNED alpha and reduces its threshold th = max(alpha) - beam beside the
next step's best exit over the same values, then masks where the next step
reads alpha (a source below th reads as -inf). The pruned best exit is the
unpruned one when its value is >= th, else (-inf, index 0), the reference's
rule for a row whose every exit is -inf; alpha0's prune and the last live
step's land before the final best exit. Pruning only replaces values below
th by -inf, so masking at use is masking at once, signs of zero included:
the emulation is held bitwise (alpha with its signs of zero, backpointers,
scores, paths) against ops/viterbi.forward_fast(beam=) with first_max and
backtrace_batch, and against JAX's viterbi_composite_batch_fast(beam=).

The stream mode's value-only exit past one warp: each warp's max of an
order-preserving key over its exits, the max over the warps' keys, and the
lowest exit index holding that value (each warp's least, then the least over
the warps; 0 where every exit is -inf). The key folds -0 into +0, which the
penalty hides unless it is zero: held bitwise against first_max at non-zero
penalties, and shown to differ at a penalty of -0.0 (a zero penalty takes
the (value, index) butterfly instead).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.ops.viterbi import viterbi_composite_batch_fast as j_fast_raw
from cs304_tpu_torch.models.hmm import (
    WordHMM,
    flagship_composite,
    stack_word_models,
    uniform_forward_log_a,
)
from cs304_tpu_torch.ops.viterbi import (
    NEG,
    backtrace_batch,
    first_max,
    forward_fast,
    pack_coefs,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

j_fast = jax.jit(j_fast_raw, static_argnames=("quirk_backtrace",))


def _composite(num_words, seed=3, d=4):
    """num_words 5-state words + a 3-state silence (503 states at 100)."""
    rng = np.random.default_rng(seed)
    models = []
    for i in range(num_words + 1):
        s = 3 if i == num_words else 5
        models.append(WordHMM(
            label="S" if i == num_words else f"w{i}",
            means=rng.normal(size=(s, d)).astype(np.float32),
            covariances=np.tile(np.eye(d, dtype=np.float32), (s, 1, 1)),
            log_a=uniform_forward_log_a(s)))
    return stack_word_models(models, penalty=-100.0)


def _fold(x):
    """The kernel's order-preserving key round trip: -0 becomes +0."""
    return x + 0.0


def deferred_forward(log_b, coefs, penalty, lengths, beam):
    """The BEAM decode mode's order: (pruned final alpha, backpointers,
    score, best exit, steps whose every exit fell below the threshold)."""
    b, t_total = log_b.shape[:2]
    s = coefs.shape[1]
    diag_ne, sub1, sub2, diag_e = coefs[0], coefs[1], coefs[2], coefs[3]
    entry, exit_ = coefs[4] > 0, coefs[5] > 0
    to = torch.arange(s, dtype=torch.int32)
    to1, to2 = torch.clamp(to - 1, min=0), torch.clamp(to - 2, min=0)
    beam = torch.tensor(beam, dtype=torch.float32)
    penalty = torch.tensor(penalty, dtype=torch.float32)
    lengths = torch.as_tensor(lengths)

    def threshold(u):  # a team max of keys, then the beam
        return _fold(u.max(dim=1, keepdim=True).values) - beam

    def exit_after_prune(u, th):
        v, i = first_max(u, exit_)  # over the unpruned values
        kept = v >= th[:, 0]
        return torch.where(kept, v, NEG), torch.where(kept, i, 0), ~kept & (v > NEG)

    u = torch.where(entry, log_b[:, 0, :s] + coefs[6], NEG)  # alpha0, unpruned
    th = threshold(u)
    bps = torch.empty((b, t_total, s), dtype=torch.int32)
    bps[:, 0] = -1
    cut = 0
    for t in range(1, t_total):
        a = torch.where(u >= th, u, NEG)  # the prune, applied where alpha is read
        bv, bi, gone = exit_after_prune(u, th)
        live = t < lengths
        cut += int((gone & live).sum())
        # The value-only exit at a non-zero penalty, (value, index) at zero.
        c_pen = ((_fold(bv) if float(penalty) != 0.0 else bv) + penalty)[:, None]
        a1 = torch.full_like(a, NEG)
        a1[:, 1:] = a[:, :-1]
        a2 = torch.full_like(a, NEG)
        a2[:, 2:] = a[:, :-2]
        c0, c1, c2 = a + diag_ne, a1 + sub1, a2 + sub2
        v12 = torch.maximum(c1, c0)
        val_ne = torch.maximum(c2, v12)
        bp_ne = torch.where(c2 >= v12, to2, torch.where(c1 >= c0, to1, to))
        c_self = a + diag_e
        val_e = torch.maximum(c_pen, c_self)
        bp_e = torch.where(c_pen >= c_self, bi[:, None].to(torch.int32), to)
        new_u = torch.where(entry, val_e, val_ne) + log_b[:, t, :s]  # unpruned, carried
        bps[:, t] = torch.where(entry, bp_e, bp_ne)
        u = torch.where(live[:, None], new_u, u)
        th = torch.where(live[:, None], threshold(new_u), th)
    score, best, _ = exit_after_prune(u, th)
    return torch.where(u >= th, u, NEG), bps, score, best, cut


def _signed_ties(rng, shape):
    """Integer-valued log_b in {-3, ..., 0} with zeros of either sign."""
    x = rng.integers(-3, 1, shape).astype(np.float32)
    return np.where((x == 0) & (rng.random(shape) < 0.5), np.float32(-0.0), x)


# states (None: the flagship, else words), B, T, beam, log_b kind, penalty,
# whether some live step prunes every exit (the (-inf, 0) fallback).
CASES = {
    "flagship-tight": (None, 8, 40, 6.0, "normal", -100.0, True),
    "flagship-wide": (None, 8, 40, 50.0, "normal", -100.0, False),
    "flagship-beam-0": (None, 8, 40, 0.0, "ties", -100.0, True),
    "flagship-inf": (None, 8, 40, float("inf"), "normal", -100.0, False),
    "flagship-ties-zero-penalty": (None, 8, 40, 4.0, "ties", 0.0, False),
    "flagship-zeros-minus-zero-penalty": (None, 8, 30, 0.0, "zeros", -0.0, False),
    "503-tight": (100, 4, 30, 10.0, "normal", -100.0, True),
    "503-ties": (100, 4, 30, 2.0, "ties", -100.0, True),
    "503-zero-penalty": (100, 4, 30, 8.0, "normal", 0.0, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deferred_prune_is_bitwise_plain_and_jax(case):
    words, b, t_total, beam, kind, penalty, cuts = CASES[case]
    comp = flagship_composite() if words is None else _composite(words)
    s = comp.num_states
    log_a = comp.log_a
    if kind == "zeros":  # every finite transition -0: exits tie at zeros
        log_a = np.where(np.isfinite(log_a), np.float32(-0.0), log_a).astype(np.float32)
    topo = (log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    rng = np.random.default_rng(len(case))
    shape = (b, t_total, s)
    if kind == "normal":
        log_b = (3 * rng.normal(size=shape)).astype(np.float32)
    elif kind == "ties":
        log_b = _signed_ties(rng, shape)
    else:
        log_b = np.where(rng.random(shape) < 0.5, np.float32(-0.0), np.float32(0.0))
    lengths = rng.integers(1, t_total + 1, b).astype(np.int32)
    lengths[0], lengths[1] = t_total, 1  # a full row and a row of length 1
    coefs = pack_coefs(*topo)
    lb = torch.as_tensor(log_b)

    alpha, bps, score, best, cut = deferred_forward(lb, coefs, penalty, lengths, beam)
    want_alpha, want_bps = forward_fast(lb, coefs, penalty, torch.as_tensor(lengths),
                                        beam=beam)
    assert torch.equal(alpha, want_alpha)
    assert torch.equal(torch.signbit(alpha), torch.signbit(want_alpha))
    assert torch.equal(bps, want_bps)
    want_score, want_best = first_max(want_alpha, coefs[5] > 0)
    assert torch.equal(score, want_score) and torch.equal(best, want_best)
    assert torch.equal(torch.signbit(score), torch.signbit(want_score))

    paths = backtrace_batch(bps, best, torch.as_tensor(lengths))
    j_score, j_paths = j_fast(jnp.asarray(log_b), *(jnp.asarray(np.asarray(x)) for x in topo),
                              jnp.float32(penalty), jnp.asarray(lengths),
                              beam=jnp.float32(beam))
    np.testing.assert_array_equal(score.numpy(), np.asarray(j_score))
    np.testing.assert_array_equal(np.signbit(score.numpy()), np.signbit(np.asarray(j_score)))
    np.testing.assert_array_equal(paths.numpy(), np.asarray(j_paths))
    assert torch.isfinite(score).float().mean().item() >= 0.5
    assert (cut > 0) == cuts


def okey(x):
    """float32 -> the kernel's order-preserving uint32 key of x + 0."""
    u = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u >> 31, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def unkey(k):
    k = np.asarray(k, np.uint32)
    return np.where(k >> 31, k & np.uint32(0x7FFFFFFF), ~k).astype(np.uint32).view(np.float32)


def team_exit(values, is_exit, k):
    """The value-only exit of a team of 32-lane warps, k states a lane:
    (vmax, index) per row, as the stream mode reduces it past one warp."""
    b, s = values.shape
    per_warp = 32 * k
    w = -(-s // per_warp)
    pad = w * per_warp - s
    v = np.concatenate([values, np.full((b, pad), -np.inf, np.float32)], axis=1)
    ex = np.concatenate([is_exit, np.zeros(pad, bool)])
    keys = np.where(ex, okey(v), okey(np.float32(-np.inf))).reshape(b, w, per_warp)
    team_key = keys.max(axis=2).max(axis=1)  # each warp's redux, then the warps'
    vmax = unkey(team_key)
    idx = np.arange(w * per_warp).reshape(w, per_warp)
    hit = ex.reshape(w, per_warp)[None] & (v.reshape(b, w, per_warp) == vmax[:, None, None])
    cand = np.where(hit, idx[None], np.iinfo(np.int32).max).min(axis=2)  # each warp's least
    best = cand.min(axis=1)  # over the warps
    return vmax, np.where(vmax > -np.inf, best, 0).astype(np.int32)


def _exit_rows(s, is_exit, rng):
    """Rows of exit values: normal, integer ties with signed zeros, a row
    whose best exits are -0 then +0, one -inf row, one with a single finite
    exit."""
    rows = np.concatenate([(3 * rng.normal(size=(6, s))).astype(np.float32),
                           _signed_ties(rng, (6, s))])
    exits = np.nonzero(is_exit)[0]
    zero = np.full((1, s), np.float32(-5.0))
    zero[0, exits[3]], zero[0, exits[-2]] = np.float32(-0.0), np.float32(0.0)
    one = np.full((1, s), -np.inf, np.float32)
    one[0, exits[-1]] = np.float32(2.5)
    return np.concatenate([rows, zero, np.full((1, s), -np.inf, np.float32), one])


@pytest.mark.parametrize("words,k", [(100, 4), (1000, 8)])  # 4 and 20 warps
@pytest.mark.parametrize("penalty", [-100.0, -25.5])
def test_multi_warp_value_only_exit_is_first_max(words, k, penalty):
    comp = _composite(words)
    s, is_exit = comp.num_states, np.asarray(comp.is_exit, bool)
    values = _exit_rows(s, is_exit, np.random.default_rng(words))
    vmax, bi = team_exit(values, is_exit, k)
    want_v, want_i = first_max(torch.as_tensor(values), torch.as_tensor(is_exit))
    got_pen = torch.as_tensor(vmax) + torch.tensor(penalty)
    want_pen = want_v + torch.tensor(penalty)
    assert torch.equal(got_pen, want_pen)
    assert torch.equal(torch.signbit(got_pen), torch.signbit(want_pen))
    np.testing.assert_array_equal(bi, want_i.numpy())


def test_minus_zero_fold_shows_only_at_a_zero_penalty():
    """The row whose lowest best exit is -0: the key's +0 plus a non-zero
    penalty equals first_max's -0 plus it, but plus a penalty of -0.0 the
    signs differ, so a zero penalty cannot take the value-only exit."""
    comp = _composite(100)
    s, is_exit = comp.num_states, np.asarray(comp.is_exit, bool)
    values = _exit_rows(s, is_exit, np.random.default_rng(0))[12:13]
    vmax, bi = team_exit(values, is_exit, 4)
    want_v, want_i = first_max(torch.as_tensor(values), torch.as_tensor(is_exit))
    assert bool(torch.signbit(want_v)[0]) and not np.signbit(vmax[0])
    assert bi[0] == int(want_i[0]) == int(np.nonzero(is_exit)[0][3])
    for penalty, hidden in ((-100.0, True), (3.0, True), (-0.0, False)):
        got = torch.as_tensor(vmax) + torch.tensor(penalty)
        want = want_v + torch.tensor(penalty)
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want)) == hidden
