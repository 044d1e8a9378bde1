"""The port's composite trellis against the JAX fast trellis and the Pallas
scan-free pair (interpret mode) where the Pallas pair spreads states over
several 128-lane tiles (130 and 260 states), and on length-1 utterances,
whose exits are all unreachable. Scores and paths must be BITWISE equal.
"""
import numpy as np
import pytest

from test_torch_viterbi import _assert_bitwise, _composite, _random_case, _run_all, _topology


@pytest.mark.parametrize("b,t,words,spw", [
    (8, 20, 30, (5, 5, 3)),   # 130 states
    (16, 18, 60, (5, 5, 3)),  # 260 states
])
def test_matches_jax_fast_and_scanfree(b, t, words, spw):
    _random_case(b, t, words, spw)


@pytest.mark.parametrize("quirk", [True, False])
def test_length_one_utterances(quirk):
    """Exits are unreachable at t=0: every exit is -inf, so the best index
    is 0 (not the first exit state) and the score is -inf."""
    comp = _composite(3, (5, 3))
    rng = np.random.default_rng(5)
    log_b = rng.normal(size=(8, 9, comp.num_states)).astype(np.float32)
    lengths = np.array([1, 9, 1, 4, 1, 2, 9, 1], np.int32)
    ref, got = _run_all(log_b, lengths, _topology(comp), quirk=quirk)
    _assert_bitwise(ref, got)
    scores, paths = got[0]
    assert np.isneginf(scores[lengths == 1]).all()
    assert (paths[lengths == 1] == 0).all()
