"""The decode-mode trellis kernel's backpointer codes, plain
(cs304_tpu_torch.ops.viterbi.backpointer_codes / backtrace_codes), against
the JAX package's viterbi_composite_batch_fast and its Pallas scan-free pair
(interpret mode).

The kernel keeps one byte per (step, state) instead of an int32
backpointer: code c in {0, 1, 2} for max(j - c, 0), or 3 for the step's one
best-exit index. Two facts make that exact, and both are held here on
forward_fast's backpointers: decoding every code gives the backpointer back
at every live step, and walking the codes gives paths BITWISE those of the
JAX decode. Inputs are made from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu_torch.models.hmm import flagship_composite
from cs304_tpu_torch.ops import viterbi as tv
from test_torch_viterbi import _composite, _topology, j_fast, j_scanfree
from torch_poison import KERNEL_POISONS, poisoned
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _decode_codes(codes, best_exit):
    j = torch.arange(codes.shape[-1], dtype=torch.int64)
    c = codes.to(torch.int64)
    return torch.where(c == 3, best_exit.to(torch.int64)[..., None],
                       torch.clamp(j - c, min=0))


def _check(log_b, lengths, topo, quirk=True, with_pallas=True):
    log_a, lower, entry, exit_, pen = topo
    jargs = (jnp.asarray(log_a), jnp.asarray(lower), jnp.asarray(entry),
             jnp.asarray(exit_), jnp.float32(pen), jnp.asarray(lengths))
    refs = [j_fast(jnp.asarray(log_b), *jargs, quirk_backtrace=quirk)]
    if with_pallas:
        refs.append(j_scanfree(jnp.asarray(log_b), *jargs, quirk_backtrace=quirk))

    coefs = tv.pack_coefs(log_a, lower, entry, exit_)
    lengths_t = torch.as_tensor(lengths)
    alpha, bp = tv.forward_fast(torch.as_tensor(log_b), coefs, float(pen), lengths_t)
    codes, best_exit = tv.backpointer_codes(bp, coefs, lengths_t)
    assert codes.dtype == torch.uint8 and best_exit.dtype == torch.int16
    assert int(codes.max()) <= 3
    t_idx = torch.arange(bp.shape[1])
    live = (t_idx >= 1)[None, :] & (t_idx[None, :] < lengths_t[:, None].long())
    decoded = _decode_codes(codes, best_exit)
    assert torch.equal(decoded[live], bp[live].long())

    scores, best = tv.first_max(alpha, coefs[5] > 0)
    paths = tv.backtrace_codes(codes, best_exit, best, lengths_t, quirk)
    assert paths.dtype == torch.int32
    for ref_s, ref_p in refs:
        np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_s))
        np.testing.assert_array_equal(paths.numpy(), np.asarray(ref_p))
    return codes, paths


# tests/test_pallas_scanfree.py's random composites.
@pytest.mark.parametrize("b,t,words,spw", [
    (16, 33, 3, (5,)),
    (8, 17, 4, (5, 3)),
    (32, 50, 12, (5, 5, 3)),
    (8, 20, 30, (5, 5, 3)),
    (16, 18, 60, (5, 5, 3)),
])
def test_codes_walk_matches_jax_on_random_composites(b, t, words, spw):
    comp = _composite(words, spw)
    rng = np.random.default_rng(1)
    log_b = (rng.normal(size=(b, t, comp.num_states)) * 3).astype(np.float32)
    lengths = rng.integers(3, t + 1, size=b).astype(np.int32)
    _check(log_b, lengths, _topology(comp))


@pytest.mark.parametrize("poison", KERNEL_POISONS)
def test_codes_walk_on_poisoned_memory_matches_jax(poison):
    """backtrace_codes' paths are a torch.empty allocation: on memory filled
    with a poison the walk stays bitwise JAX's, rows of length 1, 2 and T
    among them."""
    comp = _composite(12, (5, 5, 3))
    rng = np.random.default_rng(4)
    log_b = (rng.normal(size=(6, 24, comp.num_states)) * 3).astype(np.float32)
    lengths = np.array([24, 1, 9, 2, 17, 24], np.int32)
    with poisoned(poison):
        _check(log_b, lengths, _topology(comp), with_pallas=False)


@pytest.mark.parametrize("quirk", [True, False])
def test_codes_walk_matches_jax_on_the_flagship(quirk):
    comp = flagship_composite()
    rng = np.random.default_rng(2)
    log_b = (rng.normal(size=(16, 40, comp.num_states)) * 3).astype(np.float32)
    lengths = rng.integers(1, 41, size=16).astype(np.int32)
    codes, _ = _check(log_b, lengths, _topology(comp), quirk=quirk)
    assert (codes == 3).any()  # entries that took the step's best exit


def test_codes_walk_matches_jax_on_integer_ties():
    comp = flagship_composite()
    rng = np.random.default_rng(3)
    log_b = rng.integers(-3, 1, size=(16, 24, comp.num_states)).astype(np.float32)
    lengths = rng.integers(1, 25, size=16).astype(np.int32)
    _check(log_b, lengths, _topology(comp))


def test_codes_walk_with_every_exit_at_minus_inf():
    """Exits held at -inf: each step's best-exit index is 0, and an entry
    whose self-loop is -inf too takes it (code 3 pointing at state 0)."""
    comp = _composite(4, (5, 3))
    rng = np.random.default_rng(4)
    log_b = rng.normal(size=(6, 15, comp.num_states)).astype(np.float32)
    log_b[:3][..., np.asarray(comp.is_exit, bool)] = -np.inf
    lengths = np.array([15, 9, 1, 15, 6, 2], np.int32)
    codes, _ = _check(log_b, lengths, _topology(comp))
    _, best_exit = tv.backpointer_codes(
        tv.forward_fast(torch.as_tensor(log_b), tv.pack_coefs(*_topology(comp)[:4]),
                        comp.penalty, torch.as_tensor(lengths))[1],
        tv.pack_coefs(*_topology(comp)[:4]), torch.as_tensor(lengths))
    assert (best_exit[:3] == 0).all()


def test_codes_walk_on_length_one_and_t_one():
    comp = _composite(3, (5, 3))
    rng = np.random.default_rng(5)
    log_b = rng.normal(size=(6, 9, comp.num_states)).astype(np.float32)
    lengths = np.array([1, 9, 1, 4, 1, 2], np.int32)
    codes, paths = _check(log_b, lengths, _topology(comp))
    assert not codes[lengths == 1].any()  # no live step, no code
    assert (paths.numpy()[lengths == 1] == 0).all()
    _check(log_b[:, :1], np.ones(6, np.int32), _topology(comp))


def test_codes_walk_at_503_states():
    comp = _composite(101, (5,) * 100 + (3,))
    assert comp.num_states == 503
    rng = np.random.default_rng(6)
    log_b = (rng.normal(size=(4, 12, 503)) * 3).astype(np.float32)
    lengths = np.array([12, 7, 3, 10], np.int32)
    _check(log_b, lengths, _topology(comp))


def test_backpointer_codes_rejects_what_they_cannot_hold():
    comp = _composite(3, (5,))
    coefs = tv.pack_coefs(*_topology(comp)[:4])
    rng = np.random.default_rng(7)
    log_b = torch.as_tensor(rng.normal(size=(2, 8, comp.num_states)).astype(np.float32))
    lengths = torch.tensor([8, 8], dtype=torch.int32)
    _, bp = tv.forward_fast(log_b, coefs, comp.penalty, lengths)
    far = bp.clone()
    far[0, 3, 4] = 0  # a non-entry state pointing 4 states back
    with pytest.raises(ValueError):
        tv.backpointer_codes(far, coefs, lengths)
    split = bp.clone()
    entries = torch.nonzero(coefs[4] > 0)[:, 0]
    split[1, 5, entries[0]], split[1, 5, entries[1]] = 4, 9  # two best exits at one step
    with pytest.raises(ValueError):
        tv.backpointer_codes(split, coefs, lengths)
    # Rows past the length are not held to the scheme.
    assert tv.backpointer_codes(far, coefs, torch.tensor([3, 8], dtype=torch.int32))[0].shape == bp.shape
