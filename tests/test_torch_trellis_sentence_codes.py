"""The plain specification of what the sentence trellis's decode mode keeps on
chip: ops/viterbi.backpointer_codes / backtrace_codes applied to
banded_sentence_forward's backpointers, with a coefficient table that has
no entry or exit state. Every code is 0, 1 or 2 (back that many states,
floored at 0), and the walk from max(n_states - 1, 0) is bitwise the JAX
package's scan-free banded decode (ops/pallas/trellis_banded.py, interpret
mode) and the port's _banded_trellis_batch.

Tolerance: scores bitwise equal, paths equal within each utterance's length
(frames past it are padding), as tests/test_torch_trellis_banded.py holds
them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.ops.pallas.trellis_banded import (
    viterbi_banded_batch_scanfree as jax_scanfree,
)
from cs304_tpu_torch.models import train_fused as tf
from cs304_tpu_torch.ops import viterbi as tv
from cs304_tpu_torch.ops.cuda import trellis_banded as tb
from test_torch_trellis_banded import CASES, _assert_same, _random_problem, _torch


def _sentence_coefs(s):
    """An (8, S) table with no entry and no exit state: backpointer_codes
    then holds every state to the banded scheme."""
    return torch.zeros((8, s), dtype=torch.float32)


def _codes_decode(prob):
    log_b, c0, c1, c2, lengths, n_states = _torch(prob)
    alpha, bps = tv.banded_sentence_forward(log_b, c0, c1, c2, lengths)
    codes, best_exit = tv.backpointer_codes(bps, _sentence_coefs(log_b.shape[2]), lengths)
    assert int(codes.max()) <= 2 and not best_exit.any()
    final = tb.final_states(n_states, log_b.shape[2])
    scores = alpha.gather(1, final[:, None].to(torch.int64))[:, 0]
    return scores, tv.backtrace_codes(codes, best_exit, final, lengths)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", ["random", "ties", "degenerate", "zero-length"])
def test_sentence_codes_walk_matches_jax_interpret(case, seed):
    prob = _random_problem(np.random.default_rng(20 + seed), **CASES[case])
    got = _codes_decode(prob)
    want = jax_scanfree(*(jnp.asarray(x) for x in prob), interpret=True)
    _assert_same(want, got, prob[4])
    # and bitwise the port's plain trellis, padding frames included
    plain = tf._banded_trellis_batch(*_torch(prob))
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def test_sentence_codes_wide_and_long():
    """More states than one warp's two a lane (S = 70) and a length past T."""
    rng = np.random.default_rng(4)
    prob = list(_random_problem(rng, b=5, t=30, s=70, quantize=True))
    prob[4][1] = 31  # length > T
    got = _codes_decode(prob)
    plain = tf._banded_trellis_batch(*_torch(prob))
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def test_banded_decode_on_cpu_is_the_plain_version():
    prob = _torch(_random_problem(np.random.default_rng(6), quantize=True))
    final = tb.final_states(prob[5], prob[0].shape[2])
    before = tb.banded_decode.launches
    got = tb.banded_decode(*prob[:5], final)
    assert tb.banded_decode.launches == before  # CPU tensors launch nothing
    want = tf._banded_trellis_batch(*prob)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
