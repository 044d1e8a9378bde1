"""The port's Gaussian emissions (cs304_tpu_torch.ops.gaussian and the plain
path of ops/cuda/emission.py) against the JAX package.

Tolerances: the whitening layout is the same subtract-then-square algorithm
in float32 on both sides (rtol 1e-5, atol 1e-4 for LAPACK/BLAS summation
order); the quadratic form carries its own one-pass cancellation drift
(atol 1e-3, as tests/test_pallas_emission.py holds the Pallas kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.ops import gaussian as jg
from cs304_tpu.ops.pallas.emission import gaussian_log_pdf_fused as j_fused
from cs304_tpu_torch.ops import gaussian as tg
from cs304_tpu_torch.ops.cuda import emission as temission


def _random_gaussians(rng, s, d):
    means = rng.normal(size=(s, d)).astype(np.float32)
    a = rng.normal(size=(s, d, d)).astype(np.float32)
    covs = np.einsum("sij,skj->sik", a, a) + 2.0 * np.eye(d, dtype=np.float32)
    return means, covs


def _flagship_gaussians():
    from cs304_tpu_torch.models.hmm import flagship_composite

    c = flagship_composite()
    return c.means, c.covariances


CASES = [("small", 6, 5, 32), ("wide", 150, 7, 32), ("flagship", 58, 39, 40)]


def _case(name, s, d, n, seed=0):
    rng = np.random.default_rng(seed)
    if name == "flagship":
        means, covs = _flagship_gaussians()
    else:
        means, covs = _random_gaussians(rng, s, d)
    frames = rng.normal(size=(n, d)).astype(np.float32)
    return means, covs, frames


@pytest.mark.parametrize("name,s,d,n", CASES)
def test_whitening_log_pdf_matches_jax(name, s, d, n):
    means, covs, frames = _case(name, s, d, n)
    want = jg.gaussian_log_pdf(jg.make_gaussian_params(means, covs), frames)
    params = tg.make_gaussian_params(means, covs)
    got = tg.gaussian_log_pdf(params, torch.as_tensor(frames))
    assert got.shape == (n, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    # Batched (B, T, D) input gives the same rows.
    got_b = tg.gaussian_log_pdf(params, torch.as_tensor(frames).reshape(2, n // 2, d))
    np.testing.assert_array_equal(got_b.reshape(n, s).numpy(), got.numpy())


@pytest.mark.parametrize("name,s,d,n", CASES)
def test_quad_log_pdf_matches_jax(name, s, d, n):
    means, covs, frames = _case(name, s, d, n)
    jq = jg.make_gaussian_quad_params(means, covs)
    tq = tg.make_gaussian_quad_params(means, covs)
    np.testing.assert_allclose(tq.neg_half_p.numpy(), np.asarray(jq.neg_half_p),
                               rtol=1e-4, atol=1e-5)
    want = jg.gaussian_log_pdf_quad(jq, jnp.asarray(frames))
    got = tg.gaussian_log_pdf_quad(tq, torch.as_tensor(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    # And both stay near the whitening reference.
    exact = tg.gaussian_log_pdf(tg.make_gaussian_params(means, covs),
                                torch.as_tensor(frames))
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name,s,d,n,s_pad", [
    ("small", 6, 5, 32, 128),
    ("small", 6, 5, 32, 256),
    ("wide", 150, 7, 32, 256),
    ("flagship", 58, 39, 48, 128),
    ("flagship", 58, 39, 48, 256),
])
def test_fused_plain_matches_pallas_interpret(name, s, d, n, s_pad):
    means, covs, frames = _case(name, s, d, n)
    want = np.asarray(j_fused(jnp.asarray(means), jnp.asarray(covs),
                              jnp.asarray(frames), s_pad=s_pad,
                              interpret=True, f_blk=16))
    got = temission.gaussian_log_pdf_fused(
        torch.as_tensor(means), torch.as_tensor(covs), torch.as_tensor(frames),
        s_pad=s_pad,
    ).numpy()
    assert got.shape == want.shape == (n, s_pad)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert not got[:, s:].any() and not want[:, s:].any()


def test_fused_rejects_bad_s_pad_and_unported_tiers():
    """Bad s_pad, tier or x2_mode raise; on CPU tensors the "high" and
    "default" tiers dispatch to the split kernel's plain version (3 and 1
    bf16 passes) and launch nothing."""
    means, covs, frames = _case("small", 6, 5, 8)
    args = (torch.as_tensor(means), torch.as_tensor(covs), torch.as_tensor(frames))
    with pytest.raises(ValueError):
        temission.gaussian_log_pdf_fused(*args, s_pad=100)
    with pytest.raises(ValueError):
        temission.gaussian_log_pdf_fused(*args, precision="medium")
    with pytest.raises(ValueError):
        temission.gaussian_log_pdf_fused(*args, x2_mode="stretch")
    nhp, lin, const = temission.pack_quad_params(means, covs, 128)
    nhp_hi, nhp_lo = temission.split_hi_lo(nhp)
    before = (temission.emission.launches, temission.emission_split.launches)
    for tier, passes in (("high", 3), ("default", 1)):
        got = temission.gaussian_log_pdf_fused(*args, precision=tier)
        want = temission.emission_split_plain(args[2], nhp_hi, nhp_lo, lin, const,
                                              passes)
        np.testing.assert_array_equal(got[:, :6].numpy(), want[:, :6].numpy())
        assert not got[:, 6:].any()
    assert (temission.emission.launches, temission.emission_split.launches) == before


def test_emission_wrapper_cpu_dispatch_is_plain():
    """A CPU tensor goes to the plain version and launches nothing."""
    means, covs, frames = _case("small", 6, 5, 16)
    nhp, lin, const = temission.pack_quad_params(means, covs, 128)
    before = temission.emission.launches
    got = temission.emission(torch.as_tensor(frames), nhp, lin, const, 6, 128)
    assert temission.emission.launches == before
    want = temission.emission_plain(torch.as_tensor(frames), nhp, lin, const)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    qp = tg.make_gaussian_quad_params(means, covs)
    np.testing.assert_allclose(
        got[:, :6].numpy(),
        temission.gaussian_log_pdf_quad_plain(qp, torch.as_tensor(frames)).numpy(),
        rtol=1e-6, atol=1e-5,
    )
