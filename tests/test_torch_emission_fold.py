"""The symmetric fold of the emission kernels (ops/cuda/emission.py) against
the JAX package, on the CPU.

x2 = vec(x x^T) is symmetric, so both kernels run over its D(D+1)/2
distinct entries against nhp_sym[(i, j)] = nhp[i*D+j] + nhp[j*D+i]. The
kernels run only on the card; here the fold itself, the pair table and the
kernels' operand layouts are held against the unfolded JAX functions.

Tolerances:
- folded float32 product vs gaussian_log_pdf_fused(precision="highest",
  interpret=True): rtol 1e-4, atol 1e-3, as tests/test_pallas_emission.py
  holds K1 (float32 sums in another order and over half the terms).
- folded three-pass hi/lo product vs JAX's precision="high" interpret
  kernel: rtol 1e-4, atol 1e-2. The fold rounds nhp_ij + nhp_ji to bf16
  hi / lo once where JAX rounds each half, so the two drop different
  O(2^-16) residues; the card measured "high" within 3.1e-3 of "highest".
- folded one-pass product vs the JAX package's _dot_bf16 composition:
  rtol 1e-4, atol 2e-3. bf16(a) + bf16(b) == bf16(a + b) when the two halves
  of a pair round alike, which is almost always; where they straddle a
  rounding boundary one product moves by a bf16 ulp of nhp (2^-9 relative),
  ~1.3e-5 of the value at the flagship.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.ops.pallas import emission as jem
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import flagship_models
from cs304_tpu_torch.ops.cuda import emission as temission
from test_torch_emission_tiers import TIER_CASES, _case


def _decode(pairs):
    p = pairs.long() & 0xFFFF
    return p & 0xFF, p >> 8


@pytest.mark.parametrize("d", [1, 7, 39, 64])
def test_pair_table_covers_each_pair_once(d):
    i, j = temission.sym_pairs(d)
    k_sym = d * (d + 1) // 2
    assert len(i) == k_sym and bool((j >= i).all())
    assert len({(a, b) for a, b in zip(i.tolist(), j.tolist())}) == k_sym
    k = k_sym + d + 1
    k_pad = -(-k // 16) * 16
    ti, tj = _decode(temission.pair_table(d, k_pad, True, True))
    assert torch.equal(ti[:k_sym], i) and torch.equal(tj[:k_sym], j)
    assert torch.equal(ti[k_sym:k_sym + d], torch.arange(d))  # x_d * 1: lin rows
    assert bool((tj[k_sym:k_sym + d] == d).all())
    assert (ti[k_sym + d].item(), tj[k_sym + d].item()) == (d, d)  # 1 * 1: const
    assert bool((ti[k:] == d + 1).all() and (tj[k:] == d + 1).all())  # 0 * 0: padding
    # The folded rows: the diagonal as it is, each off-diagonal pair summed
    # once, padded rows zero. Integer weights keep the float32 sums exact.
    rng = np.random.default_rng(d)
    nhp = torch.as_tensor(rng.integers(-100, 101, size=(d * d, 24)).astype(np.float32))
    sym = temission.fold_nhp(nhp, d, k_pad)
    assert sym.shape == (k_pad, 24)
    assert not sym[k_sym:].any()
    want = torch.stack([nhp[a * d + b] + (nhp[b * d + a] if a != b else 0)
                        for a, b in zip(i.tolist(), j.tolist())])
    assert torch.equal(sym[:k_sym], want)
    # x2_sym . nhp_sym is x2 . nhp: the fold loses no term.
    x = torch.as_tensor(rng.normal(size=(5, d)).astype(np.float32)).double()
    x2 = (x[:, :, None] * x[:, None, :]).reshape(5, d * d)
    torch.testing.assert_close(temission.x2_sym(x) @ sym[:k_sym].double(),
                               x2 @ nhp.double(), rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("name,s,d,n,s_pad", TIER_CASES)
def test_folded_plain_matches_pallas_highest(name, s, d, n, s_pad):
    means, covs, frames = _case(name, s, d, n)
    want = np.asarray(jem.gaussian_log_pdf_fused(
        jnp.asarray(means), jnp.asarray(covs), jnp.asarray(frames), s_pad=s_pad,
        interpret=True, f_blk=16, precision="highest"))
    nhp, lin, const = temission.pack_quad_params(means, covs, s_pad)
    got = temission.emission_folded_plain(
        torch.as_tensor(frames), temission.fold_nhp(nhp, d), lin, const).numpy()
    np.testing.assert_allclose(got[:, :s], want[:, :s], rtol=1e-4, atol=1e-3)


def _folded_three_pass(frames, nhp, lin, const, d):
    """The "high" kernel's arithmetic on the fold: bf16 hi / lo of x2_sym
    and of nhp_sym, three exact products summed in float32, the linear
    term in float32."""
    hi, lo = temission.split_hi_lo(temission.fold_nhp(nhp, d))
    x_hi, x_lo = temission.split_hi_lo(temission.x2_sym(frames))
    quad = (x_hi.float() @ hi.float() + x_hi.float() @ lo.float()) + x_lo.float() @ hi.float()
    return quad + frames @ lin + const


@pytest.mark.parametrize("name,s,d,n,s_pad", TIER_CASES)
def test_folded_three_pass_matches_pallas_high(name, s, d, n, s_pad):
    means, covs, frames = _case(name, s, d, n)
    want = np.asarray(jem.gaussian_log_pdf_fused(
        jnp.asarray(means), jnp.asarray(covs), jnp.asarray(frames), s_pad=s_pad,
        interpret=True, f_blk=16, precision="high"))
    nhp, lin, const = temission.pack_quad_params(means, covs, s_pad)
    temission.fp32_exact()
    got = _folded_three_pass(torch.as_tensor(frames), nhp, lin, const, d).numpy()
    np.testing.assert_allclose(got[:, :s], want[:, :s], rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("name,s,d,n,s_pad", TIER_CASES)
def test_folded_one_pass_matches_dot_bf16_composition(name, s, d, n, s_pad):
    means, covs, frames = _case(name, s, d, n)
    nhp, lin, const = jem._pack_quad_params(jnp.asarray(means), jnp.asarray(covs), s_pad)
    x = jnp.asarray(frames)
    bf = jnp.bfloat16
    want = np.asarray(jem._dot_bf16(jem._build_x2(x).astype(bf), nhp.astype(bf))
                      + jem._dot_bf16(x.astype(bf), lin.astype(bf)) + const[0:1])
    t_nhp, t_lin, t_const = (torch.as_tensor(np.array(a)) for a in (nhp, lin, const[0]))
    t_x = torch.as_tensor(frames)
    temission.fp32_exact()
    # The default kernel's one bf16 pass: [x2_sym; x] against [nhp_sym; lin].
    a = torch.cat([temission.x2_sym(t_x), t_x], 1).to(torch.bfloat16).float()
    w = torch.cat([temission.fold_nhp(t_nhp, d), t_lin]).to(torch.bfloat16).float()
    got = (a @ w + t_const).numpy()
    np.testing.assert_allclose(got[:, :s], want[:, :s], rtol=1e-4, atol=2e-3)


def _unlayout(t, k_pad, n_tile):
    """Inverse of wgmma_layout: (s_pad / n_tile, k_pad * n_tile) ->
    (k_pad, s_pad)."""
    tiles = t.shape[0]
    t = t.reshape(tiles, k_pad // 8, n_tile // 8, 8, 8)
    return t.permute(1, 4, 0, 2, 3).reshape(k_pad, tiles * n_tile)


def _kernel_emulation(folded, frames, lin, const):
    """What the kernels compute from fold_quad_params' operand, with the
    pair table indexing the frame staged with x[D] = 1 and x[D+1] = 0."""
    n, d = frames.shape
    staged = torch.cat([frames, torch.ones(n, 1), torch.zeros(n, 1)], 1)
    i, j = _decode(folded.pairs)
    a = staged[:, i] * staged[:, j]
    k_pad = folded.pairs.shape[0]
    if folded.precision == "highest":
        return a @ folded.weights[0][:, : lin.shape[1]]
    w = [_unlayout(t, k_pad, folded.n_tile).float() for t in folded.weights]
    a_hi, a_lo = temission.split_hi_lo(a)
    quad = a_hi.float() @ w[0]
    if folded.precision == "high":
        return ((quad + a_hi.float() @ w[1]) + a_lo.float() @ w[0]) + frames @ lin + const
    return quad + const


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("name,s,d,n,s_pad", TIER_CASES + [("flagship", 58, 39, 48, 64)])
def test_kernel_operand_reproduces_plain_version(precision, name, s, d, n, s_pad):
    """fold_quad_params' operand (pair table, padding, the split kernel's
    wgmma core-matrix layout), multiplied out as the kernels do, against
    each tier's unfolded plain version: rtol 1e-4, atol 1e-3, the card's
    gate between each kernel and its plain version."""
    means, covs, frames = _case(name, s, d, n)
    nhp, lin, const = temission.pack_quad_params(means, covs, s_pad)
    folded = temission.fold_quad_params(nhp, lin, const, precision, s)
    assert folded.pairs.shape[0] % temission.K_STEP == 0
    x = torch.as_tensor(frames)
    temission.fp32_exact()
    got = _kernel_emulation(folded, x, lin, const)
    if precision == "highest":
        want = temission.emission_plain(x, nhp, lin, const)
    else:
        hi, lo = temission.split_hi_lo(nhp)
        want = temission.emission_split_plain(x, hi, lo, lin, const,
                                              temission.PASSES[precision])
    torch.testing.assert_close(got[:, :s], want[:, :s], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("d,passes,n_tile", [(39, 3, 64), (39, 1, 64), (64, 3, 16),
                                             (64, 1, 32), (7, 3, 64)])
def test_split_operand_fits_shared_memory(d, passes, n_tile):
    """The widest wgmma tile whose resident operand fits one block."""
    k = d * (d + 1) // 2 + (d if passes == 1 else 0)
    k_pad = -(-k // 16) * 16
    rng = np.random.default_rng(0)
    nhp = torch.as_tensor(rng.normal(size=(d * d, 64)).astype(np.float32))
    lin = torch.as_tensor(rng.normal(size=(d, 64)).astype(np.float32))
    tier = "high" if passes == 3 else "default"
    folded = temission.fold_quad_params(nhp, lin, torch.zeros(64), tier, 50)
    assert folded.n_tile == n_tile and folded.pairs.shape[0] == k_pad
    assert temission.split_smem_bytes(k_pad, d, n_tile, passes) <= temission.SMEM_MAX
    wider = [t for t in temission.SPLIT_N_TILES if t > n_tile]
    assert all(temission.split_smem_bytes(k_pad, d, t, passes) > temission.SMEM_MAX
               for t in wider)


def test_decoder_folds_only_on_the_card():
    """On the CPU the decoder keeps the unfolded split for the plain
    version and no kernel operand."""
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                            emission_precision="high", device="cpu")
    assert dec._folded is None and dec._nhp_split is not None
