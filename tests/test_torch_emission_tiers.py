"""The port's "high" and "default" emission tiers (the plain version of the
split kernel, csrc/emission_split.cu, which CPU tensors run) and the x2_mode
option against the JAX package.

Tolerances:
- "high" vs JAX gaussian_log_pdf_fused(precision="high", interpret=True):
  rtol 1e-5, atol 2e-3. Both sum the same exact bf16 products in float32,
  in different orders (~8 float32 ulps at values near -1700).
- "default" vs the JAX package's own one-pass composition
  _dot_bf16(bf16(x2), bf16(nhp)) + _dot_bf16(bf16(x), bf16(lin)) + const:
  rtol 1e-5, atol 2e-3. JAX's CPU Precision.DEFAULT is float32 (it equals
  "highest" there), so it is not the oracle of what the TPU runs; the
  composition of its helpers is.
- "high" vs the float32 whitening path: rtol 2e-3, atol 5e-2, as
  tests/test_pallas_emission.py holds the Pallas high tier.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.ops.pallas import emission as jem
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import flagship_models
from cs304_tpu_torch.ops import gaussian as tg
from cs304_tpu_torch.ops.cuda import emission as temission
from test_torch_gaussian import _flagship_gaussians, _random_gaussians

TIER_CASES = [  # name, S, D, N, s_pad: one state tile, and two (the blocked path)
    ("flagship", 58, 39, 48, 128),
    ("wide", 150, 7, 32, 256),
]


def _case(name, s, d, n, scale=5.0, seed=0):
    rng = np.random.default_rng(seed)
    means, covs = (_flagship_gaussians() if name == "flagship"
                   else _random_gaussians(rng, s, d))
    frames = (scale * rng.normal(size=(n, d))).astype(np.float32)
    return means, covs, frames


def _port(means, covs, frames, s_pad, precision, x2_mode="concat"):
    return temission.gaussian_log_pdf_fused(
        torch.as_tensor(means), torch.as_tensor(covs), torch.as_tensor(frames),
        s_pad=s_pad, precision=precision, x2_mode=x2_mode).numpy()


@pytest.mark.parametrize("name,s,d,n,s_pad", TIER_CASES)
def test_high_plain_matches_pallas_interpret(name, s, d, n, s_pad):
    means, covs, frames = _case(name, s, d, n)
    want = np.asarray(jem.gaussian_log_pdf_fused(
        jnp.asarray(means), jnp.asarray(covs), jnp.asarray(frames), s_pad=s_pad,
        interpret=True, f_blk=16, precision="high"))
    got = _port(means, covs, frames, s_pad, "high")
    assert got.shape == want.shape == (n, s_pad)
    np.testing.assert_allclose(got[:, :s], want[:, :s], rtol=1e-5, atol=2e-3)
    assert not got[:, s:].any()
    # The three passes keep ~16 mantissa bits: near the exact path.
    exact = tg.gaussian_log_pdf(tg.make_gaussian_params(means, covs),
                                torch.as_tensor(frames)).numpy()
    np.testing.assert_allclose(got[:, :s], exact, rtol=2e-3, atol=5e-2)


@pytest.mark.parametrize("name,s,d,n,s_pad", TIER_CASES)
def test_default_plain_matches_one_pass_composition(name, s, d, n, s_pad):
    """On the JAX package's packed parameters (one bf16 rounding of nhp
    that lands on the other side of a tie moves a value by up to ~0.4 at
    this scale, so both sides take the same float32 nhp)."""
    means, covs, frames = _case(name, s, d, n)
    nhp, lin, const = jem._pack_quad_params(jnp.asarray(means), jnp.asarray(covs), s_pad)
    x = jnp.asarray(frames)
    bf = jnp.bfloat16
    want = np.asarray(jem._dot_bf16(jem._build_x2(x).astype(bf), nhp.astype(bf))
                      + jem._dot_bf16(x.astype(bf), lin.astype(bf)) + const[0:1])
    t_nhp, t_lin, t_const = (torch.as_tensor(np.array(a)) for a in (nhp, lin, const[0]))
    nhp_hi, nhp_lo = temission.split_hi_lo(t_nhp)
    got = temission.emission_split(torch.as_tensor(frames), nhp_hi, None, t_lin,
                                   t_const, s, s_pad, passes=1).numpy()
    np.testing.assert_allclose(got[:, :s], want[:, :s], rtol=1e-5, atol=2e-3)
    assert not got[:, s:].any()
    # One bf16 pass is far from the three-pass tier at this feature scale.
    high = temission.emission_split(torch.as_tensor(frames), nhp_hi, nhp_lo, t_lin,
                                    t_const, s, s_pad, passes=3).numpy()
    assert np.abs(got - high).max() > 50 * 2e-3


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_selmm_mode_bitwise_equals_concat(precision):
    means, covs, frames = _case("wide", 150, 7, 32)
    for s_pad in (256, 384):
        concat = _port(means, covs, frames, s_pad, precision, "concat")
        selmm = _port(means, covs, frames, s_pad, precision, "selmm")
        np.testing.assert_array_equal(selmm, concat)


def test_split_hi_lo_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64, 40)) * 10.0 ** rng.integers(-3, 4, size=(64, 40))
         ).astype(np.float32)
    want_hi, want_lo = jem._split_hi_lo(jnp.asarray(x))
    hi, lo = temission.split_hi_lo(torch.as_tensor(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.float().numpy(), np.asarray(want_hi, np.float32))
    np.testing.assert_array_equal(lo.float().numpy(), np.asarray(want_lo, np.float32))


def test_tier_and_x2_mode_errors():
    with pytest.raises(ValueError, match="require emissions='quad'"):
        ContinuousDecoder(flagship_models(), device="cpu", emission_precision="high")
    with pytest.raises(ValueError, match="require emissions='quad'"):
        ContinuousDecoder(flagship_models(), device="cpu", emissions="whiten",
                          emission_precision="default")
    means, covs, frames = _case("wide", 150, 7, 8)
    with pytest.raises(ValueError, match="x2_mode"):
        _port(means, covs, frames, 256, "highest", x2_mode="mxu")
    nhp, lin, const = temission.pack_quad_params(means, covs, 256)
    with pytest.raises(ValueError):
        temission.emission_split(torch.as_tensor(frames), nhp.bfloat16(), None, lin,
                                 const, 150, 256, passes=2)


def test_decode_batch_fused_high_matches_pallas_interpret():
    """The fused decode at "high" against the JAX package's, whose hi/lo
    kernel runs in interpret mode: scores within rtol 1e-4, word sequences
    equal."""
    from cs304_tpu.ops.mfcc import mfcc_features_batch as j_mfcc
    from cs304_tpu.ops.pallas.emission import decode_batch_fused as j_decode
    from cs304_tpu_torch.data.batching import make_signals
    from cs304_tpu_torch.models.hmm import flagship_composite

    comp = flagship_composite()
    sig = make_signals(4, 1.0, seed=13)
    feats, n_frames = j_mfcc(sig, np.full(4, sig.shape[1], np.int32))
    feats, n_frames = np.array(feats), np.array(n_frames)
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    j_s, j_p = j_decode(jnp.asarray(comp.means), jnp.asarray(comp.covariances),
                        *(jnp.asarray(a) for a in topo), jnp.float32(comp.penalty),
                        jnp.asarray(feats), jnp.asarray(n_frames), interpret=True,
                        precision="high")
    t_s, t_p = temission.decode_batch_fused(
        torch.as_tensor(comp.means), torch.as_tensor(comp.covariances), *topo,
        comp.penalty, torch.as_tensor(feats), torch.as_tensor(n_frames),
        precision="high")
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=1e-4)
    j_p, t_p = np.asarray(j_p), t_p.numpy()
    for i, n in enumerate(n_frames):
        assert comp.path_to_labels(t_p[i, :n]) == comp.path_to_labels(j_p[i, :n])
