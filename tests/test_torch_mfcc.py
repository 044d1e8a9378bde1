"""The port's MFCC front-end (cs304_tpu_torch.ops.mfcc) against the JAX one.

Same numpy signals into both. Tolerance: atol 1e-4 on the 39-dim features,
because the DFT's two halves (and the mel/DCT products) are summed in a
different order by PyTorch's and XLA's CPU matmuls, and log() after the
power spectrum turns those last-bit differences into ~2e-5 absolute drift
on features of magnitude ~5 (measured max 3.9e-5). "cmn" gets atol 5e-4:
it subtracts per-utterance means from raw cepstra of magnitude ~500, where
one float32 ulp is 6e-5, and leaves the result unscaled (measured max
1.8e-4).
"""
import numpy as np
import pytest
import torch

from cs304_tpu.ops import mfcc as jmfcc
from cs304_tpu_torch.ops import mfcc as tmfcc

ATOL = 1e-4
ATOL_CMN = 5e-4


def _signals(seed=0, b=3, length=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 16000
    sig = (rng.normal(size=(b, length)) * 3000).astype(np.float32)
    sig[0] = (np.sin(2 * np.pi * 440 * t) * 6000
              + rng.normal(0, 50, length)).astype(np.float32)
    return sig


@pytest.mark.parametrize("kw", [
    {},                                     # n_fft=320/hop=160: hop*2 == n_fft blocks
    {"n_fft": 400},                         # 25 ms / 10 ms: the g-block path (g=40)
    {"spectrogram": "fft"},
    {"n_fft": 400, "spectrogram": "fft"},   # gather framing + rfft
    {"normalization": "cmn"},
    {"normalization": "cmvn"},
    {"n_fft": 400, "normalization": "cmvn"},
])
def test_mfcc_features_batch_matches_jax(kw):
    sig = _signals()
    n_samples = np.array([16000, 11111, 5000], np.int32)  # ragged
    fj, nj = jmfcc.mfcc_features_batch(sig, n_samples, jmfcc.MFCCConfig(**kw))
    fp, np_ = tmfcc.mfcc_features_batch(
        torch.as_tensor(sig), torch.as_tensor(n_samples), tmfcc.MFCCConfig(**kw)
    )
    np.testing.assert_array_equal(np_.numpy(), np.asarray(nj))
    assert fp.shape == (3, 101, 39) and fp.dtype == torch.float32
    atol = ATOL_CMN if kw.get("normalization") == "cmn" else ATOL
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=atol)
    # Rows past each clip's frame count are exactly zero.
    for i, n in enumerate(np_.numpy()):
        assert not fp[i, n:].any()


def test_mfcc_features_single_matches_jax():
    sig = _signals(seed=1, b=1, length=12345)[0]
    fj, nj = jmfcc.mfcc_features(sig, 9000)
    fp, np_ = tmfcc.mfcc_features(torch.as_tensor(sig), 9000)
    assert int(np_) == int(nj)
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=ATOL)


def test_mfcc_batch_matches_jax():
    sig = _signals(seed=2)
    clips = [sig[0, :16000], sig[1, :7000], sig[2, :3000]]
    want = jmfcc.mfcc_batch(clips)
    got = tmfcc.mfcc_batch(clips)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_mfcc_constants_match_jax():
    cfg = jmfcc.MFCCConfig(n_fft=400)
    for a, b in zip(jmfcc._constants(cfg)[:5],
                    tmfcc._constants(tmfcc.MFCCConfig(n_fft=400))[:5]):
        np.testing.assert_array_equal(a, b)
    assert tmfcc._framing_blocks(tmfcc.MFCCConfig(n_fft=400)) == 40


def test_mfcc_rejects_unported_precision():
    with pytest.raises(NotImplementedError):
        tmfcc.mfcc_features_batch(
            torch.zeros(1, 4000), torch.tensor([4000]),
            tmfcc.MFCCConfig(precision="high"),
        )
