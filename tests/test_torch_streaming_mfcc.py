"""The port's causal front end (cs304_tpu_torch/ops/streaming_mfcc.py, host
NumPy) against the JAX package's, bitwise: the same samples in the same
chunks give the same frames from every feed() and finalize(), the same
per-feed mel peak, and mel_peak gives the same calibration value."""
import numpy as np
import pytest

from cs304_tpu.ops.mfcc import MFCCConfig as JaxMFCCConfig
from cs304_tpu.ops.streaming_mfcc import StreamingMFCC as JaxStreamingMFCC
from cs304_tpu.ops.streaming_mfcc import mel_peak as jax_mel_peak
from cs304_tpu_torch.ops.mfcc import MFCCConfig
from cs304_tpu_torch.ops.streaming_mfcc import StreamingMFCC, mel_peak


def _signal(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    sig = np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1330 * t)
    return (sig * 5000 * rng.uniform(0.2, 1.0) + rng.normal(0, 40, n)).astype(np.float32)


@pytest.mark.parametrize("splits", [1, 7, 40])
def test_feed_and_finalize_are_bitwise_jax(splits):
    sig = _signal(splits, 6400)
    ref = mel_peak(sig[:3200])
    assert ref == jax_mel_peak(sig[:3200])
    ours, theirs = StreamingMFCC(ref_power=ref), JaxStreamingMFCC(ref_power=ref)
    for chunk in np.array_split(sig, splits):
        got, want = ours.feed(chunk), theirs.feed(chunk)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert ours.last_feed_mel_peak == theirs.last_feed_mel_peak
    np.testing.assert_array_equal(ours.finalize(), theirs.finalize())


def test_mel_peak_short_signals_and_config_are_jax():
    for n in (0, 1, 159, 160, 321, 4000):
        sig = _signal(n, n)
        assert mel_peak(sig) == jax_mel_peak(sig)
    cfg = MFCCConfig(n_mels=26, fmax=7000.0)
    jcfg = JaxMFCCConfig(n_mels=26, fmax=7000.0)
    sig = _signal(9, 2000)
    assert mel_peak(sig, cfg) == jax_mel_peak(sig, jcfg)
    ours, theirs = StreamingMFCC(cfg, ref_power=1e6), JaxStreamingMFCC(jcfg, ref_power=1e6)
    np.testing.assert_array_equal(ours.feed(sig), theirs.feed(sig))
    np.testing.assert_array_equal(ours.finalize(), theirs.finalize())
    with pytest.raises(ValueError, match="per_frame"):
        StreamingMFCC(MFCCConfig(normalization="cmvn"))
