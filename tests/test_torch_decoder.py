"""The port's ContinuousDecoder against the JAX package's: predict_batch /
predict_signal_batch / viterbi_batch on the 58-state flagship. The port runs
its plain versions here (CPU tensors); the JAX Pallas kernels run in
interpret mode. The fused decode is in test_torch_decoder_fused.py.

Emissions differ from JAX only in float32 summation order, so transcripts
must be identical and scores agree to rtol 1e-4.
"""
import numpy as np
import pytest
import torch

from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu_torch.data.batching import make_signals
from cs304_tpu_torch.device import resolve_device
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import flagship_composite, flagship_models
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _jax_models():
    return [JWordHMM(label=m.label, means=m.means, covariances=m.covariances,
                     log_a=m.log_a) for m in flagship_models()]


def _sampled_features(seed, n, min_words=1, max_words=4):
    """Feature sequences drawn from the flagship's own state Gaussians along
    random word sequences, so decodes produce real multi-word transcripts."""
    rng = np.random.default_rng(seed)
    models = {m.label: m for m in flagship_models()}
    labels = sorted(models)
    out = []
    for _ in range(n):
        frames = []
        for _ in range(int(rng.integers(min_words, max_words + 1))):
            m = models[labels[int(rng.integers(len(labels)))]]
            for s in range(m.num_states):
                for _ in range(int(rng.integers(2, 6))):
                    frames.append(rng.multivariate_normal(m.means[s], m.covariances[s]))
        out.append(np.asarray(frames, np.float32))
    return out


@pytest.mark.parametrize("emissions", ["whiten", "quad"])
def test_predict_batch_matches_jax_scanfree(emissions):
    feats = _sampled_features(1, 10)
    want = JDecoder(_jax_models(), penalty=-100.0, backend="scanfree",
                    emissions=emissions).predict_batch(feats)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0,
                            emissions=emissions, device="cpu")
    assert dec.backend == "fast"
    assert dec.predict_batch(feats) == want
    assert any(len(w) > 1 for w in want)  # real multi-word transcripts
    scanfree = ContinuousDecoder(flagship_models(), penalty=-100.0,
                                 backend="scanfree", emissions=emissions,
                                 device="cpu")
    assert scanfree.predict_batch(feats) == want


def test_viterbi_batch_matches_jax():
    feats = _sampled_features(2, 6) + [np.zeros((140, 39), np.float32)]
    j_s, j_p, j_l = JDecoder(_jax_models(), penalty=-100.0).viterbi_batch(feats)
    t_s, t_p, t_l = ContinuousDecoder(flagship_models(), penalty=-100.0,
                                      device="cpu").viterbi_batch(feats)
    np.testing.assert_array_equal(t_l, j_l)
    assert t_p.shape == j_p.shape  # padded to the longest bucket
    np.testing.assert_allclose(t_s, j_s, rtol=1e-4)
    comp = flagship_composite()
    for i, n in enumerate(t_l):
        assert comp.path_to_labels(t_p[i, :n]) == comp.path_to_labels(j_p[i, :n])


def test_predict_signal_batch_matches_jax_scanfree():
    # Ragged clips in one 1 s bucket, five rows padded to a batch of eight.
    sig = list(make_signals(3, 1.0, seed=3)) + list(make_signals(2, 0.7, seed=4))
    want = JDecoder(_jax_models(), penalty=-100.0, backend="scanfree",
                    emissions="quad").predict_signal_batch(sig)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                            backend="scanfree", device="cpu")
    assert dec.predict_signal_batch(sig) == want
    # Another bucket and batch size decode each clip the same.
    longer = [make_signals(1, 1.3, seed=5)[0]]
    assert dec.predict_signal_batch(sig[:2] + longer) == (
        dec.predict_signal_batch(sig[:2]) + dec.predict_signal_batch(longer))


def test_word_buffer_overflow_falls_back_to_host_walk():
    """More than MAX_WORDS words in one utterance: predict_batch reads the
    full path on the host instead of truncating."""
    from cs304_tpu_torch.models import decoder as tdec

    feats = _sampled_features(5, 2, min_words=3, max_words=4)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, device="cpu")
    want = dec.predict_batch(feats)
    old = tdec.MAX_WORDS
    tdec.MAX_WORDS = 1
    try:
        assert dec.predict_batch(feats) == want
    finally:
        tdec.MAX_WORDS = old


def test_resolve_device_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the test is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        ContinuousDecoder(flagship_models(), device="cuda")
    # No silent CPU: the default device is the card, and without one it
    # raises; the CPU runs only when it is asked for.
    for default in (None, "auto"):
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(default)
    with pytest.raises(RuntimeError):
        ContinuousDecoder(flagship_models())
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("kwargs", [{"beam": 50.0}, {"bigram": "trained"}])
def test_unported_options_raise(kwargs):
    """beam= and bigram= raised before the search slice was ported; now
    they decode as the JAX decoder does (tests/test_torch_bigram_beam.py
    holds every backend and the trellis bitwise)."""
    from cs304_tpu.ops import lm as jlm
    from cs304_tpu_torch.ops import lm as tlm

    feats = _sampled_features(17, 4)
    jkw, tkw = dict(kwargs), dict(kwargs)
    if "bigram" in kwargs:
        corpus, labels = ["12", "375", "4Z", "9O2", "186Z"], flagship_composite().labels
        jkw["bigram"] = jlm.train_word_bigram(corpus, labels)
        tkw["bigram"] = tlm.train_word_bigram(corpus, labels)
    want = JDecoder(_jax_models(), penalty=-100.0, **jkw).predict_batch(feats)
    assert ContinuousDecoder(flagship_models(), penalty=-100.0, device="cpu",
                             **tkw).predict_batch(feats) == want


def test_gmm_models_raise():
    """GMM word models decode (the port refused them before GMMs were
    ported): the flagship's words as K = 2 GMMs give the JAX decoder's
    transcripts (tests/test_torch_gmm_decode.py holds the rest)."""
    from cs304_tpu.models.gmm_hmm import GMMWordHMM as JGMMWordHMM
    from cs304_tpu_torch.models.gmm_hmm import GMMWordHMM

    gmm = [GMMWordHMM(label=m.label, means=np.stack([m.means, m.means + 0.5], 1),
                      covariances=np.stack([m.covariances] * 2, 1),
                      weights=np.full((m.num_states, 2), 0.5, np.float32), log_a=m.log_a)
           for m in flagship_models()]
    jgmm = [JGMMWordHMM(m.label, m.means, m.covariances, m.weights, m.log_a) for m in gmm]
    feats = _sampled_features(4, 4)
    want = JDecoder(jgmm, penalty=-100.0, backend="fast").predict_batch(feats)
    assert ContinuousDecoder(gmm, penalty=-100.0, device="cpu").predict_batch(feats) == want
