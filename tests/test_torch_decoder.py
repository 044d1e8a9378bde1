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
    assert resolve_device(None).type == "cpu"


@pytest.mark.parametrize("kwargs", [
    {"backend": "scan"}, {"backend": "pallas"}, {"beam": 50.0},
    {"bigram": object()}, {"emissions": "quad", "emission_precision": "high"},
])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        ContinuousDecoder(flagship_models(), device="cpu", **kwargs)


def test_gmm_models_raise():
    class GMMWord:
        label = "1"
        weights = np.ones((5, 2), np.float32)

    with pytest.raises(NotImplementedError):
        ContinuousDecoder([GMMWord()], device="cpu")
