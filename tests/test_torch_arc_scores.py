"""Lattice rescoring's arc scores on the sentence trellis K3
(ops/rescore.arc_acoustic_scores, one banded_forward call over all arcs)
and K3's per-row t = 0 seed (ops/viterbi.banded_sentence_forward), on the
CPU, where K3 runs its plain version.

- banded_sentence_forward without a seed is bitwise what it was (the seed
  of its self-loop rule, a non-finite self-loop counting as 0, passed
  explicitly gives the same alpha and backpointers); with a seed, alpha_0
  is log_b[:, 0, 0] + seed at state 0 alone.
- arc_acoustic_scores bitwise the JAX package's (max-plus needs only adds
  and compares) on an exhaustive lattice, arcs at start 0 and past it, a
  five-state word cut to the band, an entry self-loop of -inf (seeded 0),
  at skip 1 and 2; skip 3, which K3 does not take, raises ValueError on
  the CPU as on the card.
- lattice_rescore on that lattice: the same score, text and arcs as JAX's.
"""
import numpy as np
import pytest
import torch

from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu.models.hmm import stack_word_models as j_stack
from cs304_tpu.ops import rescore as jr
from cs304_tpu_torch.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a
from cs304_tpu_torch.ops import rescore as tr
from cs304_tpu_torch.ops.viterbi import banded_sentence_forward
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _composites(seed=0):
    """The same composite from both packages: words of 3, 5 and 2 states,
    the 5-state one with a full upper triangle (skips past the band) and the
    3-state one with an entry self-loop of probability 0."""
    rng = np.random.default_rng(seed)
    tm, jm = [], []
    for label, s in (("A", 3), ("B", 5), ("S", 2)):
        a = rng.normal(size=(s, 4, 2)).astype(np.float32)
        covs = a @ a.transpose(0, 2, 1) + np.eye(4, dtype=np.float32)
        means = rng.normal(size=(s, 4)).astype(np.float32) * 3
        log_a = uniform_forward_log_a(s)
        if label == "A":
            log_a[0, 0] = -np.inf
            log_a[0, 1:] = np.log(0.5)
        tm.append(WordHMM(label, means, covs, log_a))
        jm.append(JWordHMM(label, means, covs, log_a))
    return stack_word_models(tm, -4.0), j_stack(jm, -4.0)


def _log_b(jc, seed, t):
    feats = (np.random.default_rng(seed).normal(size=(t, 4)) * 2).astype(np.float32)
    return np.asarray(jc.log_likelihoods(feats))


def test_banded_sentence_forward_seed():
    rng = np.random.default_rng(5)
    b, t, s = 6, 9, 7
    log_b = torch.from_numpy((rng.normal(size=(b, t, s)) * 2).astype(np.float32))
    c = [torch.from_numpy(rng.normal(size=(b, s)).astype(np.float32)) for _ in range(3)]
    c[0][1, 0] = float("-inf")  # the self-loop rule's non-finite case
    c[1][:, 0] = c[2][:, :2] = float("-inf")
    lengths = torch.tensor([9, 4, 1, 9, 2, 7], dtype=torch.int32)
    alpha, bp = banded_sentence_forward(log_b, *c, lengths)
    rule = torch.where(torch.isfinite(c[0][:, 0]), c[0][:, 0], torch.zeros(b))
    alpha_r, bp_r = banded_sentence_forward(log_b, *c, lengths, rule)
    assert torch.equal(alpha.view(torch.int32), alpha_r.view(torch.int32))
    assert torch.equal(bp, bp_r)
    seed = torch.from_numpy(rng.normal(size=b).astype(np.float32))
    seed[3] = 0.0
    alpha_s, _bp = banded_sentence_forward(log_b, *c, torch.ones(b, dtype=torch.int32), seed)
    assert torch.equal(alpha_s[:, 0], log_b[:, 0, 0] + seed)
    assert bool(torch.isneginf(alpha_s[:, 1:]).all())


@pytest.mark.parametrize("skip", [1, 2])
def test_arc_scores_are_bitwise_jax(skip):
    tc, jc = _composites(1)
    log_b = _log_b(jc, 1, 10)
    arcs = tr.exhaustive_lattice(tc, 10).arcs
    assert {a.start == 0 for a in arcs} == {True, False}
    got = tr.arc_acoustic_scores(tc, arcs, log_b=log_b, skip=skip, device="cpu")
    want = jr.arc_acoustic_scores(jc, arcs, log_b=log_b, skip=skip)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and np.isfinite(got).mean() > 0.5


@pytest.mark.parametrize("skip", [-1, 3])
def test_arc_scores_refuse_a_skip_k3_does_not_take(skip):
    tc, jc = _composites(1)
    log_b = _log_b(jc, 1, 6)
    arcs = tr.exhaustive_lattice(tc, 6).arcs
    with pytest.raises(ValueError, match="skip 0, 1 or 2"):
        tr.arc_acoustic_scores(tc, arcs, log_b=log_b, skip=skip, device="cpu")


def test_exhaustive_lattice_rescore_matches_jax():
    tc, jc = _composites(2)
    log_b = _log_b(jc, 2, 12)
    lat = tr.exhaustive_lattice(tc, 12)
    got = tr.lattice_rescore(tc, lat, log_b=log_b, penalty=-3.0, skip_silence=False,
                             device="cpu")
    want = jr.lattice_rescore(jc, lat, log_b=log_b, penalty=-3.0, skip_silence=False)
    assert got[0] == want[0] and got[1] == want[1]
    assert [(a.start, a.end, a.label) for a in got[2]] == \
        [(a.start, a.end, a.label) for a in want[2]]
