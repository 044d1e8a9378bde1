"""The port's MAP adaptation (models/adapt.py) against the JAX package's, on
the CPU: the same models (D = 6, single-Gaussian and K=2 GMM) and the same
seeded enrollment utterances, shifted by a constant offset, through both.

Tolerance: adapted means within atol 1e-5 / rtol 1e-5 of JAX's (the
statistics are integer-valued counts and float32 frame sums, summed in
float64 on the host in both packages; the GMM responsibilities go through
a softmax that XLA and torch round apart in the last bits); covariances,
weights and transitions are the inputs' own, bitwise. self_adapt keeps the
same utterances as JAX's and adapts to the same means.
"""
import numpy as np
import pytest

from cs304_tpu.models import adapt as jadapt
from cs304_tpu.models.gmm_hmm import GMMWordHMM as JGMMWordHMM
from cs304_tpu_torch.models import adapt as tadapt
from cs304_tpu_torch.models.train_continuous_gmm import promote_to_gmm
from test_torch_train_fused import jax_models, make_corpus, make_models


def _shifted(models, transcripts, n_per, seed, shift=0.8):
    labeled = make_corpus(models, transcripts, n_per, seed=seed)
    off = np.random.default_rng(seed).normal(0, shift, 6).astype(np.float32)
    return {tr: [f + off for f in feats] for tr, feats in labeled.items()}


def _same_means(port, jax, atol=1e-5):
    assert sorted(port) == sorted(jax)
    for label in jax:
        np.testing.assert_allclose(port[label].means, jax[label].means,
                                   rtol=1e-5, atol=atol, err_msg=label)
        np.testing.assert_array_equal(port[label].covariances, jax[label].covariances)
        np.testing.assert_array_equal(port[label].log_a, jax[label].log_a)


@pytest.mark.parametrize("tau,adapt_silence,cross_word", [
    (20.0, True, "exit_only"), (3.0, False, "exit_only"), (10.0, True, "band")])
def test_map_adapt_matches_jax(tau, adapt_silence, cross_word):
    models = make_models(seed=1)
    enroll = _shifted(models, ["12", "31"], 2, seed=5)
    port = tadapt.map_adapt(models, enroll, tau=tau, adapt_silence=adapt_silence,
                            cross_word=cross_word, device="cpu")
    jax = jadapt.map_adapt(jax_models(models), enroll, tau=tau,
                           adapt_silence=adapt_silence, cross_word=cross_word)
    _same_means(port, jax)
    moved = not np.allclose(port["1"].means, models["1"].means)
    assert moved and (port["S"] is models["S"]) == (not adapt_silence)
    assert port["1"] is not models["1"]  # a new dict; the input is not mutated


def test_gmm_map_adapt_matches_jax():
    gmm = promote_to_gmm(make_models(seed=1), 2)
    enroll = _shifted(make_models(seed=1), ["12", "3"], 2, seed=7)
    port = tadapt.map_adapt(gmm, enroll, tau=5.0, device="cpu")
    jgmm = {k: JGMMWordHMM(label=m.label, means=m.means, covariances=m.covariances,
                           weights=m.weights, log_a=m.log_a) for k, m in gmm.items()}
    jax = jadapt.map_adapt(jgmm, enroll, tau=5.0)
    _same_means(port, jax)
    for label in jax:
        np.testing.assert_array_equal(port[label].weights, jax[label].weights)


def test_self_adapt_matches_jax():
    models = make_models(seed=1)
    feats = [f for fs in _shifted(models, ["12", "3", "21"], 2, seed=9).values()
             for f in fs]
    port, kept = tadapt.self_adapt(models, feats, tau=1.0, min_confidence=0.5,
                                   device="cpu")
    jax, jkept = jadapt.self_adapt(jax_models(models), feats, tau=1.0, min_confidence=0.5)
    assert kept == jkept > 0
    _same_means(port, jax)
    same, none = tadapt.self_adapt(models, feats, min_confidence=1.1, device="cpu")
    assert none == 0 and same is models


def test_adapt_rejects_what_jax_rejects():
    models = make_models(seed=1)
    enroll = _shifted(models, ["12"], 1, seed=5)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="tau"):
            tadapt.map_adapt(models, enroll, tau=bad, device="cpu")
    mixed = dict(models)
    mixed["1"] = promote_to_gmm({"1": models["1"]}, 2)["1"]
    with pytest.raises(ValueError, match="uniform"):
        tadapt.map_adapt(mixed, enroll, device="cpu")
    with pytest.raises(ValueError, match="unknown words"):
        tadapt.map_adapt(models, {"19": enroll["12"]}, device="cpu")
    with pytest.raises(ValueError, match="no enrollment"):
        tadapt.map_adapt(models, {}, device="cpu")
