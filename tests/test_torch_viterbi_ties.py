"""Exact-tie and short-time cases of the port's composite trellis
against the JAX package's fast trellis and Pallas scan-free pair (interpret
mode): the tie-break order (skip-2, skip-1, self; exits before the entry
self-loop; lowest exit index) and T=1 / T=2 / B=5 batches. Scores and paths
must be BITWISE equal.
"""
import numpy as np
import pytest

from test_torch_viterbi import _assert_bitwise, _composite, _run_all, _topology


def _tie_topology(lowers, uppers, log_a, penalty):
    s = log_a.shape[0]
    lower_of = np.zeros(s, np.int32)
    for lo in lowers:
        lower_of[lo:] = lo
    is_entry = np.zeros(s, bool)
    is_exit = np.zeros(s, bool)
    is_entry[list(lowers)] = True
    is_exit[list(uppers)] = True
    return log_a, lower_of, is_entry, is_exit, np.float32(penalty)


def test_exit_beats_self_loop_on_exact_tie():
    """tests/test_tie_break.py's first case: at t=2 entry 2 ties exactly
    between its self-loop and exit 3 + penalty; the exit must win."""
    s = 4
    log_a = np.full((s, s), -np.inf, np.float32)
    log_a[0, 0], log_a[0, 1], log_a[1, 1] = -1.0, -1.0, -1.0
    log_a[2, 2], log_a[2, 3], log_a[3, 3] = -1.0, -2.0, 0.0
    log_b = np.zeros((3, s), np.float32)
    log_b[0, 0] = -10.0
    log_b[1, 2] = -4.0
    topo = _tie_topology([0, 2], [1, 3], log_a, -4.0)
    ref, got = _run_all(log_b[None], np.array([3], np.int32), topo)
    _assert_bitwise(ref, got)
    assert got[0][1][0, 1] == 3


def test_lowest_exit_wins_among_tied_exits():
    s = 4
    log_a = np.full((s, s), -np.inf, np.float32)
    log_a[0, 0], log_a[0, 1], log_a[1, 1] = -1.0, -1.0, -1.0
    log_a[2, 2], log_a[2, 3], log_a[3, 3] = -1.0, -1.0, -1.0
    log_b = np.zeros((3, s), np.float32)
    topo = _tie_topology([0, 2], [1, 3], log_a, -2.0)
    _assert_bitwise(*_run_all(log_b[None], np.array([3], np.int32), topo))


def test_integer_valued_log_b_forces_ties():
    """Small-integer emissions make exact ties everywhere in the trellis."""
    comp = _composite(6, (5, 3))
    rng = np.random.default_rng(9)
    log_b = rng.integers(-3, 1, size=(8, 24, comp.num_states)).astype(np.float32)
    lengths = rng.integers(1, 25, size=8).astype(np.int32)
    _assert_bitwise(*_run_all(log_b, lengths, _topology(comp)))


@pytest.mark.parametrize("t", [1, 2, 12])
def test_batch_of_five_and_short_time(t):
    """B=5 (the Pallas pair falls back to the scan there) and T=1, T=2."""
    comp = _composite(2, (5, 3))
    rng = np.random.default_rng(3 + t)
    log_b = rng.normal(size=(5, t, comp.num_states)).astype(np.float32)
    lengths = np.minimum(np.array([12, 7, 3, 12, 1], np.int32), t)
    _assert_bitwise(*_run_all(log_b, lengths, _topology(comp)))
