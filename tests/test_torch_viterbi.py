"""The port's composite trellis (cs304_tpu_torch.ops.viterbi, the plain
version of the CUDA scan-free pair) against the JAX package's
viterbi_composite_batch_fast and its Pallas scan-free pair (interpret mode).

Max-plus uses only float32 adds and compares, so scores and full padded
paths must be BITWISE equal. Tie and short-time cases are in
test_torch_viterbi_ties.py, multi-tile shapes and unreachable exits in
test_torch_viterbi_wide.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a
from cs304_tpu.ops.pallas.trellis_scanfree import viterbi_composite_batch_scanfree
from cs304_tpu.ops.viterbi import viterbi_composite_batch_fast
from cs304_tpu_torch.ops import viterbi as tv
from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
from torch_poison import KERNEL_POISONS, plain_run, poisoned


# One compiled program per shape (eager op-by-op dispatch compiles ~5x longer).
j_fast = jax.jit(viterbi_composite_batch_fast, static_argnames=("quirk_backtrace",))
j_scanfree = jax.jit(viterbi_composite_batch_scanfree,
                     static_argnames=("quirk_backtrace", "interpret"))


def _composite(num_words, states_per_word, seed=0):
    rng = np.random.default_rng(seed)
    models = []
    for i in range(num_words):
        s = states_per_word[i % len(states_per_word)]
        means = rng.normal(size=(s, 4)).astype(np.float32)
        covs = np.tile(np.eye(4, dtype=np.float32), (s, 1, 1))
        models.append(WordHMM(label=str(i), means=means, covariances=covs,
                              log_a=uniform_forward_log_a(s)))
    return stack_word_models(models, penalty=-25.0)


def _topology(comp):
    return (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
            np.float32(comp.penalty))


def _run_all(log_b, lengths, topo, quirk=True, with_pallas=True):
    log_a, lower, entry, exit_, pen = topo
    jargs = (jnp.asarray(log_a), jnp.asarray(lower), jnp.asarray(entry),
             jnp.asarray(exit_), jnp.float32(pen), jnp.asarray(lengths))
    ref = [tuple(np.asarray(x) for x in j_fast(jnp.asarray(log_b), *jargs,
                                                 quirk_backtrace=quirk))]
    if with_pallas:
        ref.append(tuple(np.asarray(x) for x in j_scanfree(
            jnp.asarray(log_b), *jargs, quirk_backtrace=quirk)))
    targs = (log_a, lower, entry, exit_, float(pen), torch.as_tensor(lengths))
    got = [
        tv.viterbi_composite_batch_fast(torch.as_tensor(log_b), *targs,
                                        quirk_backtrace=quirk),
        tsf.viterbi_composite_batch_scanfree(torch.as_tensor(log_b), *targs,
                                             quirk_backtrace=quirk),
    ]
    return ref, [(s.numpy(), p.numpy()) for s, p in got]


def _assert_bitwise(ref, got):
    for rs, rp in ref:
        for gs, gp in got:
            assert gp.dtype == np.int32
            np.testing.assert_array_equal(gs, rs)
            np.testing.assert_array_equal(gp, rp)


def _random_case(b, t, words, spw):
    comp = _composite(words, spw)
    rng = np.random.default_rng(1)
    log_b = (rng.normal(size=(b, t, comp.num_states)) * 3).astype(np.float32)
    lengths = rng.integers(3, t + 1, size=b).astype(np.int32)
    _assert_bitwise(*_run_all(log_b, lengths, _topology(comp)))


# The shapes of tests/test_pallas_scanfree.py; the multi-tile ones (130 and
# 260 states) are in test_torch_viterbi_wide.py.
@pytest.mark.parametrize("b,t,words,spw", [
    (16, 33, 3, (5,)),
    (8, 17, 4, (5, 3)),       # mixed word sizes incl. silence-like 3-state
    (32, 50, 12, (5, 5, 3)),  # the flagship 58-state shape
])
def test_matches_jax_fast_and_scanfree(b, t, words, spw):
    _random_case(b, t, words, spw)


@pytest.mark.parametrize("poison", KERNEL_POISONS)
def test_plain_trellis_on_poisoned_memory_matches_jax(poison):
    """forward_fast's backpointers, backtrace_batch's paths and
    backtrace_codes' (the scan-free pair's plain decode) are torch.empty
    allocations: on memory filled with a poison, scores and full padded
    paths stay bitwise JAX's (rows of length 1 and 2 among them), and every
    backpointer cell, past a row's length too, equals the one written on
    memory filled with another pattern."""
    comp = _composite(12, (5, 5, 3))
    rng = np.random.default_rng(21)
    log_b = (rng.normal(size=(6, 20, comp.num_states)) * 3).astype(np.float32)
    lengths = np.array([20, 1, 7, 2, 13, 20], np.int32)
    coefs = tv.pack_coefs(*_topology(comp)[:4])
    with poisoned(poison):
        ref, got = _run_all(log_b, lengths, _topology(comp), with_pallas=False)
        _alpha, bps = tv.forward_fast(torch.as_tensor(log_b), coefs, comp.penalty,
                                      torch.as_tensor(lengths))
    _assert_bitwise(ref, got)
    want = plain_run(tv.forward_fast, torch.as_tensor(log_b), coefs, comp.penalty,
                     torch.as_tensor(lengths))[1]
    assert torch.equal(bps, want)


def test_standard_backtrace():
    comp = _composite(3, (5,))
    rng = np.random.default_rng(2)
    log_b = rng.normal(size=(8, 21, comp.num_states)).astype(np.float32)
    lengths = np.full(8, 21, np.int32)
    _assert_bitwise(*_run_all(log_b, lengths, _topology(comp), quirk=False))


def test_padded_state_columns_are_ignored():
    """The trellis reads only the first S columns of a padded log_b (the
    emission kernel's 128-column layout)."""
    comp = _composite(4, (5, 3))
    s = comp.num_states
    rng = np.random.default_rng(11)
    log_b = rng.normal(size=(4, 10, s)).astype(np.float32)
    padded = np.concatenate(
        [log_b, rng.normal(size=(4, 10, 128 - s)).astype(np.float32)], axis=2)
    lengths = np.array([10, 6, 2, 9], np.int32)
    coefs = tv.pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    want = tsf.viterbi_composite_batch_scanfree(
        torch.as_tensor(log_b), *_topology(comp)[:4], comp.penalty,
        torch.as_tensor(lengths))
    got = tsf.scanfree_decode(torch.as_tensor(padded), coefs, comp.penalty,
                              torch.as_tensor(lengths))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_pack_coefs_matches_pallas_layout():
    from cs304_tpu.ops.pallas.trellis_scanfree import _pack_coefs

    comp = _composite(5, (5, 3))
    s = comp.num_states
    want = np.asarray(_pack_coefs(jnp.asarray(comp.log_a),
                                  jnp.asarray(comp.lower_of_state),
                                  jnp.asarray(comp.is_entry),
                                  jnp.asarray(comp.is_exit), 128))
    got = tsf.pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry,
                         comp.is_exit).numpy()
    np.testing.assert_array_equal(got, want[:, :s])


def test_single_utterance_backtrace_matches_batch():
    comp = _composite(3, (5,))
    rng = np.random.default_rng(12)
    log_b = torch.as_tensor(rng.normal(size=(2, 15, comp.num_states)).astype(np.float32))
    coefs = tv.pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    lengths = torch.tensor([15, 8], dtype=torch.int32)
    alpha, bps = tv.forward_fast(log_b, coefs, comp.penalty, lengths)
    _, best = tv.first_max(alpha, coefs[5] > 0)
    paths = tv.backtrace_batch(bps, best, lengths)
    for i in range(2):
        one = tv._backtrace(bps[i], best[i], lengths[i])
        np.testing.assert_array_equal(one.numpy(), paths[i].numpy())


def test_unported_options_raise():
    """beam= and pair_penalty= raised before the search slice was ported;
    now they give the JAX fast step's scores and paths bitwise
    (tests/test_torch_bigram_beam.py holds the rest)."""
    comp = _composite(2, (5,))
    rng = np.random.default_rng(6)
    log_b = (rng.normal(size=(3, 12, comp.num_states)) * 3).astype(np.float32)
    lengths = np.array([12, 7, 1], np.int32)
    log_a, lower, entry, exit_, pen = _topology(comp)
    pair = np.array([[-3.0, -9.0], [0.0, -1.0]], np.float32)
    for kw in ({"beam": 10.0}, {"pair_penalty": pair}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        ws, wp = j_fast(jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lower),
                        jnp.asarray(entry), jnp.asarray(exit_), jnp.float32(pen),
                        jnp.asarray(lengths), word_of_state=jnp.asarray(comp.word_of_state),
                        uppers=jnp.asarray(comp.uppers), **jkw)
        gs, gp = tv.viterbi_composite_batch_fast(
            torch.as_tensor(log_b), log_a, lower, entry, exit_, float(pen),
            torch.as_tensor(lengths), word_of_state=comp.word_of_state,
            uppers=comp.uppers, **kw)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_trellis_wrappers_cpu_dispatch_is_plain():
    comp = _composite(3, (5, 3))
    rng = np.random.default_rng(13)
    log_b = torch.as_tensor(rng.normal(size=(3, 7, comp.num_states)).astype(np.float32))
    lengths = torch.tensor([7, 5, 1], dtype=torch.int32)
    coefs = tsf.pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    counters = (tsf.scanfree_decode, tsf.trellis_forward, tsf.trellis_backtrace)
    before = [c.launches for c in counters]
    tsf.scanfree_decode(log_b, coefs, comp.penalty, lengths)
    assert [c.launches for c in counters] == before
