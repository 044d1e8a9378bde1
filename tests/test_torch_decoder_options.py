"""Decoder arguments the JAX ContinuousDecoder takes, in the port:
viterbi_batch(..., bucket=False) and ContinuousDecoder(lm_weight=...), held
against the JAX decoder on the 58-state flagship (the port on CPU tensors,
its plain versions).

Emissions differ from JAX only in float32 summation order: lengths and path
shapes equal, scores to rtol 1e-4, labels along each path equal.
"""
import numpy as np
import pytest

from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import flagship_composite, flagship_models
from test_torch_decoder import _jax_models, _sampled_features


def _two_buckets():
    """A ragged list spanning the 128- and 256-frame buckets."""
    feats = _sampled_features(7, 5)
    rng = np.random.default_rng(8)
    feats.append(rng.normal(size=(150, 39)).astype(np.float32))
    lengths = {-(-f.shape[0] // 128) for f in feats}
    assert lengths == {1, 2}
    return feats


@pytest.mark.parametrize("bucket", [False, True])
def test_viterbi_batch_bucket_matches_jax(bucket):
    feats = _two_buckets()
    j_s, j_p, j_l = JDecoder(_jax_models(), penalty=-100.0).viterbi_batch(
        feats, bucket=bucket)
    t_s, t_p, t_l = ContinuousDecoder(flagship_models(), penalty=-100.0,
                                      device="cpu").viterbi_batch(feats, bucket=bucket)
    np.testing.assert_array_equal(t_l, j_l)
    assert t_p.shape == j_p.shape == (len(feats), 256)
    np.testing.assert_allclose(t_s, j_s, rtol=1e-4)
    comp = flagship_composite()
    for i, n in enumerate(t_l):
        assert comp.path_to_labels(t_p[i, :n]) == comp.path_to_labels(j_p[i, :n])


def test_viterbi_batch_unbucketed_decodes_each_utterance_alike():
    """One 256-frame batch or a batch per bucket: the same scores and the
    same paths within each length."""
    feats = _two_buckets()
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, device="cpu")
    s_b, p_b, l_b = dec.viterbi_batch(feats)
    s_u, p_u, l_u = dec.viterbi_batch(feats, bucket=False)
    np.testing.assert_array_equal(l_b, l_u)
    np.testing.assert_allclose(s_b, s_u, rtol=1e-6)
    for i, n in enumerate(l_b):
        np.testing.assert_array_equal(p_b[i, :n], p_u[i, :n])


def test_lm_weight_without_bigram_matches_jax():
    feats = _sampled_features(9, 6)
    want = JDecoder(_jax_models(), penalty=-100.0, lm_weight=0.3).predict_batch(feats)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, lm_weight=0.3, device="cpu")
    assert dec.predict_batch(feats) == want
    assert dec.predict_batch(feats) == ContinuousDecoder(
        flagship_models(), penalty=-100.0, device="cpu").predict_batch(feats)


def test_bigram_still_raises_with_lm_weight():
    """A bigram with lm_weight raised before the search slice was ported;
    now it weighs the LM as the JAX decoder does."""
    from cs304_tpu.ops import lm as jlm
    from cs304_tpu_torch.ops import lm as tlm

    feats = _sampled_features(9, 6)
    corpus = ["12", "4Z", "375", "9O2", "186Z", "54321"]
    labels = sorted(m.label for m in flagship_models())
    want = JDecoder(_jax_models(), penalty=-100.0, lm_weight=0.5,
                    bigram=jlm.train_word_bigram(corpus, labels)).predict_batch(feats)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, lm_weight=0.5,
                            bigram=tlm.train_word_bigram(corpus, labels), device="cpu")
    assert dec.predict_batch(feats) == want
