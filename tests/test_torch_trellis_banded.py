"""The port's banded sentence trellis (K3's plain version and the wrapper's
CPU dispatch) against the JAX package: train_fused._banded_trellis_batch and
the Pallas kernel in interpret mode (ops/pallas/trellis_banded.py).

Tolerance: scores bitwise equal; paths equal within each utterance's length
(frames past it are padding). Max-plus is float32 adds and compares only, so
exact equality is the contract. Problems follow tests/test_pallas_banded.py:
-inf sprinkling, quantized exact ties, a degenerate entry self-loop, ragged
n_states; plus length-0 rows and T = 1.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.models.train_fused import _banded_trellis_batch as jax_banded
from cs304_tpu.ops.pallas.trellis_banded import (
    viterbi_banded_batch_scanfree as jax_scanfree,
)
from cs304_tpu_torch.models import train_fused as tf
from cs304_tpu_torch.ops.cuda import trellis_banded as tb
from cs304_tpu_torch.ops.viterbi import banded_sentence_forward
from torch_poison import KERNEL_POISONS, differing_cells, plain_run, poisoned

NEG = -np.inf


def _random_problem(rng, b=8, t=12, s=9, quantize=False, degenerate=False,
                    zero_length=False):
    log_b = rng.normal(size=(b, t, s)).astype(np.float32)
    if quantize:
        log_b = np.round(log_b)  # force exact ties in the max-plus updates
    c0 = rng.normal(size=(b, s)).astype(np.float32) * 0.5
    c1 = rng.normal(size=(b, s)).astype(np.float32) * 0.5
    c2 = rng.normal(size=(b, s)).astype(np.float32) * 0.5
    if quantize:
        c0, c1, c2 = np.round(c0), np.round(c1), np.round(c2)
    c1[:, 0] = NEG
    c2[:, :2] = NEG
    for c in (c0, c1, c2):
        c[rng.random(c.shape) < 0.15] = NEG
    if degenerate:
        c0[:, 0] = NEG  # zero-probability entry self-loop (init must survive)
    n_states = rng.integers(3, s + 1, size=b).astype(np.int32)
    lengths = rng.integers(2, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    if zero_length:
        lengths[1::3] = 0
    return log_b, c0, c1, c2, lengths, n_states


def _torch(prob):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in prob]


def _assert_same(want, got, lengths):
    w_s, w_p = (np.asarray(x) for x in want)
    g_s, g_p = (x.numpy() for x in got)
    np.testing.assert_array_equal(w_s, g_s)
    assert g_p.dtype == np.int32
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(w_p[b, :n], g_p[b, :n], err_msg=f"utt {b}")


CASES = {
    "random": {},
    "ties": {"quantize": True},
    "degenerate": {"degenerate": True},
    "zero-length": {"zero_length": True, "quantize": True},
    "T1": {"t": 1},
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_banded_trellis_matches_jax(seed, case):
    rng = np.random.default_rng(seed)
    kw = dict(CASES[case])
    if kw.get("t") == 1:
        prob = _random_problem(rng, t=2, **{k: v for k, v in kw.items() if k != "t"})
        log_b = prob[0][:, :1]
        prob = (log_b, *prob[1:4], np.minimum(prob[4], 1), prob[5])
    else:
        prob = _random_problem(rng, **kw)
    lengths = prob[4]
    want = jax_banded(*(jnp.asarray(x) for x in prob))
    got_plain = tf._banded_trellis_batch(*_torch(prob))
    _assert_same(want, got_plain, lengths)
    # The wrapper on CPU tensors is the same plain computation.
    got_wrapper = tb.viterbi_banded_batch_scanfree(*_torch(prob))
    _assert_same(want, got_wrapper, lengths)


@pytest.mark.parametrize("poison", KERNEL_POISONS)
def test_plain_banded_trellis_on_poisoned_memory_matches_jax(poison):
    """banded_sentence_forward's backpointers (K3's plain version) and the
    backtrace's paths are torch.empty allocations: on memory filled with a
    poison the decode stays JAX's (length-0 rows and ties among them), and
    alpha, every backpointer and the full padded paths equal those written
    on memory filled with another pattern."""
    prob = _random_problem(np.random.default_rng(5), zero_length=True, quantize=True)

    def run():
        return (tf._banded_trellis_batch(*_torch(prob)),
                banded_sentence_forward(*_torch(prob)[:5]))

    with poisoned(poison):
        got = run()
    _assert_same(jax_banded(*(jnp.asarray(x) for x in prob)), got[0], prob[4])
    assert differing_cells(got, plain_run(run)) == 0


@pytest.mark.parametrize("case", ["random", "ties", "degenerate", "zero-length"])
def test_plain_banded_trellis_matches_interpret_pallas(case):
    rng = np.random.default_rng(11)
    prob = _random_problem(rng, **CASES[case])
    want = jax_scanfree(*(jnp.asarray(x) for x in prob), interpret=True)
    _assert_same(want, tb.viterbi_banded_batch_scanfree(*_torch(prob)), prob[4])


def test_training_trellis_backends_agree_and_count_no_cpu_launch():
    rng = np.random.default_rng(5)
    prob = _torch(_random_problem(rng, quantize=True))
    counters = (tb.banded_decode, tb.banded_forward)
    before = [c.launches for c in counters]
    saved = tf._TRELLIS_BACKEND
    try:
        assert saved == "scanfree"  # the port's default
        got_k = tf._training_trellis(*prob)
        tf._TRELLIS_BACKEND = "scan"
        got_s = tf._training_trellis(*prob)
        tf._TRELLIS_BACKEND = "bogus"
        with pytest.raises(ValueError):
            tf._training_trellis(*prob)
    finally:
        tf._TRELLIS_BACKEND = saved
    assert torch.equal(got_k[0], got_s[0]) and torch.equal(got_k[1], got_s[1])
    # CPU tensors run the plain version: the kernels' counters do not move.
    assert [c.launches for c in counters] == before


def test_wrapper_rejects_n_states_past_the_trellis():
    rng = np.random.default_rng(2)
    log_b, c0, c1, c2, lengths, n_states = _torch(_random_problem(rng))
    with pytest.raises(ValueError):
        tb.viterbi_banded_batch_scanfree(log_b, c0, c1, c2, lengths, n_states + 20)
