"""The port's k-best composite Viterbi (cs304_tpu_torch.ops.nbest) against
the JAX package's ops/nbest.py on the CPU: the k-best forward's final
scores and packed backpointers bitwise on the same log_b (the top K a
stable descending sort, the lower index first on a tie, as jax.lax.top_k;
integer-valued log_b make ties), nbest_decode's hypotheses equal, the
top-1 state path equal to the decoder's path, no duplicate prefixes from
single-state words, and ContinuousDecoder.predict_nbest on single-Gaussian
and K = 2 GMM models equal to the JAX decoder's, its top-1 the 1-best
transcript (tests/test_embedded_gmm.py:161-165's GMM check)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu.models.hmm import stack_word_models as j_stack
from cs304_tpu.ops import nbest as jnb
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a
from cs304_tpu_torch.ops import nbest as tnb
from test_torch_decoder import _sampled_features
from test_torch_gmm_decode import _gmm_models, _to_jax
from test_torch_viterbi import _composite
from test_torch_bigram_beam import one_torch_thread  # noqa: F401


def _models(seed, spec, d=6):
    rng = np.random.default_rng(seed)
    return [WordHMM(label, rng.normal(size=(s, d)).astype(np.float32) * 2,
                    np.tile(np.eye(d, dtype=np.float32), (s, 1, 1)),
                    uniform_forward_log_a(s)) for label, s in spec]


def _j_forward(log_b, comp, k):
    return jnb.kbest_composite_forward(
        jnp.asarray(log_b), jnp.asarray(comp.log_a), jnp.asarray(comp.lower_of_state),
        jnp.asarray(comp.is_entry), jnp.asarray(comp.is_exit), comp.penalty, k=k)


@pytest.mark.parametrize("words,spw,k,ties", [
    (3, (5,), 4, False),
    (4, (5, 3), 8, True),      # integer log_b: tied candidates in every top K
    (5, (1, 3), 4, True),      # single-state words: the duplicate-prefix rule
    (12, (5, 5, 3), 8, False),
])
def test_kbest_forward_is_bitwise_jax(words, spw, k, ties):
    comp = _composite(words, spw)
    rng = np.random.default_rng(words + k)
    shape = (25, comp.num_states)
    log_b = (rng.integers(-2, 1, shape) if ties else rng.normal(size=shape) * 3)
    log_b = log_b.astype(np.float32)
    ja, jb = _j_forward(log_b, comp, k)
    ta, tb = tnb.kbest_composite_forward(torch.as_tensor(log_b), comp.log_a,
                                         comp.lower_of_state, comp.is_entry,
                                         comp.is_exit, comp.penalty, k=k)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert np.isfinite(np.asarray(ja)).any()


def test_top_k_keeps_the_lower_index_first():
    x = torch.tensor([[3.0, 1.0, 3.0, 3.0, float("-inf"), float("-inf"), 1.0]])
    values, idx = tnb.top_k(x, 6)
    assert idx.tolist() == [[0, 2, 3, 1, 6, 4]]
    assert values[0, -1].item() == float("-inf")


def test_nbest_decode_matches_jax_and_brute_force():
    models = _models(0, [("A", 3), ("B", 3)], d=4)
    tcomp = stack_word_models(models, penalty=-2.0)
    jcomp = j_stack([_to_jax({m.label: m for m in models})[m.label] for m in models], -2.0)
    feats = (np.random.default_rng(1).normal(size=(14, 4)) * 2).astype(np.float32)
    for n in (1, 3, 5):
        want = jnb.nbest_decode(jcomp, feats, n=n)
        got = tnb.nbest_decode(tcomp, feats, n=n, device="cpu")
        assert [t for _s, t in got] == [t for _s, t in want]
        np.testing.assert_allclose([s for s, _t in got], [s for s, _t in want], rtol=1e-6)
        assert len({t for _s, t in got}) == len(got)
    # The k-best top 4 of a tiny trellis against brute-force enumeration.
    comp = _composite(2, (2, 3))
    log_b = np.random.default_rng(2).normal(size=(5, comp.num_states)).astype(np.float32)
    alpha, bps = tnb.kbest_composite_forward(torch.as_tensor(log_b), comp.log_a,
                                             comp.lower_of_state, comp.is_entry,
                                             comp.is_exit, comp.penalty, k=4)
    hyps = tnb.nbest_paths(alpha.numpy(), bps.numpy(), comp.is_exit, 5, 4,
                           quirk_backtrace=False)
    from cs304_tpu_torch.ops.viterbi import composite_transition_matrix

    trans = composite_transition_matrix(comp.log_a, comp.lower_of_state, comp.is_entry,
                                        comp.is_exit, comp.penalty).numpy()
    diag = np.diagonal(comp.log_a)
    init = np.where(comp.is_entry, log_b[0] + np.where(np.isfinite(diag), diag, 0), -np.inf)
    scored = []
    for seq in itertools.product(range(comp.num_states), repeat=5):
        if np.isfinite(init[seq[0]]) and comp.is_exit[seq[-1]]:
            sc = init[seq[0]] + sum(trans[seq[t - 1], seq[t]] + log_b[t, seq[t]]
                                    for t in range(1, 5))
            if np.isfinite(sc):
                scored.append(sc)
    np.testing.assert_allclose([h[0] for h in hyps], sorted(scored, reverse=True)[:4],
                               rtol=1e-5)


def test_nbest_top1_is_the_decoder_path_and_prefixes_are_distinct():
    models = _models(11, [("1", 5), ("2", 5), ("S", 3)], d=8)
    dec = ContinuousDecoder(models, penalty=-40.0, device="cpu")
    comp = dec.composite
    feats = np.random.default_rng(11).normal(size=(30, 8)).astype(np.float32)
    _scores, paths, _lengths = dec.viterbi_batch([feats])
    alpha, bps = tnb.kbest_composite_forward(comp.log_likelihoods(feats, device="cpu"),
                                             comp.log_a, comp.lower_of_state,
                                             comp.is_entry, comp.is_exit, comp.penalty, k=4)
    hyps = tnb.nbest_paths(alpha.numpy(), bps.numpy(), comp.is_exit, 30, 1)
    np.testing.assert_array_equal(hyps[0][1], paths[0, :30])
    single = _models(3, [("A", 1), ("B", 2)])
    comp = ContinuousDecoder(single, penalty=-5.0, device="cpu").composite
    feats = np.random.default_rng(3).normal(size=(12, 6)).astype(np.float32)
    alpha, bps = tnb.kbest_composite_forward(comp.log_likelihoods(feats, device="cpu"),
                                             comp.log_a, comp.lower_of_state,
                                             comp.is_entry, comp.is_exit, comp.penalty, k=4)
    hyps = tnb.nbest_paths(alpha.numpy(), bps.numpy(), comp.is_exit, 12, 8,
                           quirk_backtrace=False)
    keys = [tuple(p.tolist()) for _s, p in hyps]
    assert len(keys) == len(set(keys)) > 1


@pytest.mark.parametrize("gmm", [False, True])
def test_predict_nbest_matches_jax(gmm):
    from test_torch_decoder import _jax_models
    from cs304_tpu_torch.models.hmm import flagship_models

    models = _gmm_models() if gmm else {m.label: m for m in flagship_models()}
    jmodels = _to_jax(models) if gmm else _jax_models()
    jdec = JDecoder(jmodels, penalty=-100.0)
    tdec = ContinuousDecoder(models, penalty=-100.0, device="cpu")
    for x in _sampled_features(31, 2, min_words=2, max_words=3):
        want = jdec.predict_nbest(x, n=3)
        got = tdec.predict_nbest(x, n=3)
        assert got, "no n-best hypotheses"
        assert [t for _s, t in got] == [t for _s, t in want]
        np.testing.assert_allclose([s for s, _t in got], [s for s, _t in want], rtol=1e-5)
        # Scored with the decoder's own densities (the GMMs' on a GMM
        # checkpoint): the top-1 is the 1-best transcript.
        assert got[0][1] == tdec.predict(x)
