"""The port's MFCC precision tiers (MFCCConfig(precision="high" |
"default"), ops/mfcc.py:_dot) on the CPU.

The tiers act where the JAX package's do: the DFT, mel and DCT products;
the Savitzky-Golay deltas stay exact float32 at every tier. "high" is the
bf16_3x product (hi*hi + hi*lo + lo*hi of a bfloat16 split, each product
exact in float32); every other tier is the float32 product, as the JAX
package's _precision maps all but "high" to HIGHEST. JAX's CPU runs every
tier in float32, so:
- JAX's "high" and "default" features are held against the port's
  "highest", and the port's "default" against JAX's "default", within the
  atol of tests/test_torch_mfcc.py (1e-4; with cmvn also rtol 1e-4, see
  test_default_matches_jax_default);
- the port's "high" against its own "highest" within HIGH_ATOL (measured
  max |delta| 1.1e-3 per-frame, 2.7e-3 with cmvn), and its "default" is
  its "highest" bit for bit.
"""
import numpy as np
import pytest
import torch

from cs304_tpu.ops import mfcc as jmfcc
from cs304_tpu_torch.data.batching import make_signals
from cs304_tpu_torch.ops import mfcc as tmfcc

ATOL = 1e-4  # tests/test_torch_mfcc.py
HIGH_ATOL = 1e-2


def _features(cfg_kw, signals):
    x = torch.as_tensor(signals)
    n = torch.full((x.shape[0],), x.shape[1])
    return tmfcc.mfcc_features_batch(x, n, tmfcc.MFCCConfig(**cfg_kw))[0].numpy()


SIGNALS = make_signals(4, 1.0, seed=11)


CONFIGS = [{}, {"n_fft": 400}, {"normalization": "cmvn"}]


@pytest.mark.parametrize("kw", CONFIGS)
def test_tiers_within_their_bounds_of_highest(kw):
    ref = _features(kw, SIGNALS)
    high = np.abs(_features({**kw, "precision": "high"}, SIGNALS) - ref)
    assert 0 < high.max() <= HIGH_ATOL  # "high" rounds, within its bound
    np.testing.assert_array_equal(_features({**kw, "precision": "default"}, SIGNALS), ref)


@pytest.mark.parametrize("kw", CONFIGS)
def test_default_matches_jax_default(kw):
    sigs = SIGNALS[:2]
    jcfg = jmfcc.MFCCConfig(**{**kw, "precision": "default"})
    want = np.asarray(jmfcc.mfcc_features_batch(
        sigs, np.full(2, sigs.shape[1], np.int32), jcfg)[0])
    # cmvn divides by each utterance's std: on these signals the packages'
    # float difference reaches 1.06e-4 there (2.9e-5 relative, on a feature
    # of ~3.6), so cmvn adds rtol 1e-4 to the atol.
    rtol = 1e-4 if kw.get("normalization") == "cmvn" else 0
    np.testing.assert_allclose(_features({**kw, "precision": "default"}, sigs), want,
                               atol=ATOL, rtol=rtol)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_jax_tiers_are_float32_on_the_cpu(precision):
    """JAX's CPU computes its tiers in float32: they match the port's
    "highest"."""
    sigs = SIGNALS[:2]
    got = np.asarray(jmfcc.mfcc_features_batch(
        sigs, np.full(2, sigs.shape[1], np.int32),
        jmfcc.MFCCConfig(precision=precision))[0])
    np.testing.assert_allclose(got, _features({}, sigs), atol=ATOL, rtol=0)


def test_dot_tiers_are_bf16_split_products():
    """_dot: "high" = hi@hi + (hi@lo + lo@hi) over bfloat16 parts widened to
    float32; "highest" and "default" the float32 product."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(7, 33)).astype(np.float32) * 1e3)
    b = torch.as_tensor(rng.normal(size=(33, 5)).astype(np.float32))
    a_hi = a.to(torch.bfloat16).float()
    a_lo = (a - a_hi).to(torch.bfloat16).float()
    b_hi = b.to(torch.bfloat16).float()
    b_lo = (b - b_hi).to(torch.bfloat16).float()
    assert torch.equal(tmfcc._dot(a, b, "highest"), a @ b)
    assert torch.equal(tmfcc._dot(a, b, "default"), a @ b)
    assert torch.equal(tmfcc._dot(a, b, "high"), a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi))
    # The lo terms carry: "high" is far closer to the exact product than
    # one bf16 pass.
    exact = a.double() @ b.double()
    err_high = float((tmfcc._dot(a, b, "high").double() - exact).abs().max())
    err_one_pass = float(((a_hi @ b_hi).double() - exact).abs().max())
    assert err_high < 1e-2 * err_one_pass


def test_mfcc_batch_runs_each_tier():
    clips = [s[: 8000 + 1000 * i] for i, s in enumerate(SIGNALS)]
    for precision in tmfcc.PRECISIONS:
        cfg = tmfcc.MFCCConfig(precision=precision)
        out = tmfcc.mfcc_batch(clips, cfg=cfg, device="cpu")
        assert [f.shape for f in out] == [(cfg.num_frames(len(c)), 39) for c in clips]
        assert all(np.isfinite(f).all() for f in out)
