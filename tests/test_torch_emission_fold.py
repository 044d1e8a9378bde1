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


def _split_values(folded, frames):
    """The split kernel's A values from its group descriptors: group g's
    value t is x[i] * x[j0 + t] on the row staged as [x, 1, 0, ...] of
    split_x_stride(D), or its bf16 rounding / residual by the group's flag,
    at K row split_row_of(G)[g, t]."""
    n, d = frames.shape
    xs = temission.split_x_stride(d)
    staged = torch.cat([frames, torch.ones(n, 1), torch.zeros(n, xs - d - 1)], 1)
    desc = folded.pairs.long()
    i, j0, flag = desc & 0xFF, (desc >> 8) & 0xFF, desc >> 16
    rows = temission.split_row_of(len(desc))
    a = torch.zeros(n, folded.k_pad)
    for t in range(4):
        v = staged[:, i] * staged[:, j0 + t]
        r = v.to(torch.bfloat16).float()
        v = torch.where(flag == temission.GROUP_ROUND, r,
                        torch.where(flag == temission.GROUP_RESIDUAL, v - r, v))
        a[:, rows[:, t]] = v
    return a


def _kernel_emulation(folded, frames, lin, const):
    """What the kernels compute from fold_quad_params' operand: K1 with the
    pair table indexing the frame staged with x[D] = 1 and x[D+1] = 0, the
    split kernel with its group descriptors (_split_values)."""
    n, d = frames.shape
    k_pad = folded.k_pad
    if folded.precision == "highest":
        staged = torch.cat([frames, torch.ones(n, 1), torch.zeros(n, 1)], 1)
        i, j = _decode(folded.pairs)
        return (staged[:, i] * staged[:, j]) @ folded.weights[0][:, : lin.shape[1]]
    a = _split_values(folded, frames)
    w = [_unlayout(t, k_pad, folded.n_tile)[:, : lin.shape[1]].float()
         for t in folded.weights]
    a_hi, a_lo = temission.split_hi_lo(a)
    quad = a_hi.float() @ w[0]
    if folded.precision == "high":
        return ((quad + a_hi.float() @ w[1]) + a_lo.float() @ w[0]) + const
    return quad + const


def test_split_thirds_are_exact_and_the_six_products_reach_float32():
    """split_thirds keeps x's whole mantissa (x == t1 + t2 + t3 exactly),
    and the "high" tier's six products of thirds reproduce x * l to within
    a few float32 ulps, as Precision.HIGHEST's do."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor((rng.normal(size=4096) * 10.0 ** rng.integers(-3, 4, 4096))
                        .astype(np.float32))
    t = [p.double() for p in temission.split_thirds(x)]
    assert torch.equal(t[0] + t[1] + t[2], x.double())
    l = torch.as_tensor(rng.normal(size=4096).astype(np.float32)) * 7
    u = [p.double() for p in temission.split_thirds(l)]
    six = t[0] * u[0] + t[0] * u[1] + t[1] * u[0] + t[1] * u[1] + t[2] * u[0] + t[0] * u[2]
    exact = x.double() * l.double()
    assert bool(((six - exact).abs() <= 4 * 2.0 ** -24 * exact.abs()).all())


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
    assert folded.k_pad % temission.K_STEP == 0
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


# (D, passes, states, state tile): the split kernel's operand cases, here
# and in tests/test_torch_cuda_kernels.py (its ring's stages, on the card).
SPLIT_OPERAND_CASES = [(39, 3, 50, 64), (39, 1, 116, 128), (64, 3, 503, 256),
                       (64, 1, 5003, 256), (7, 3, 58, 64)]


@pytest.mark.parametrize("d,passes,num_states,n_tile", SPLIT_OPERAND_CASES)
def test_split_operand_shape(d, passes, num_states, n_tile):
    """The split kernel's streamed operand: the state tile covering up to
    256 states, every pair (i <= j) in exactly one group row with its folded
    weight and every other pair row weighted zero, K padded to whole ring
    stages, each stage's SPLIT_KC rows of a tile one contiguous chunk in the
    core-matrix layout. That the ring holds at least 3 stages at full width
    (no narrower fallback: D = 64 runs at 256 states too) is the kernel's
    own decision, checked on the card (test_split_ring_holds_three_stages)."""
    s_pad = -(-num_states // 128) * 128
    rng = np.random.default_rng(d)
    nhp = torch.as_tensor(rng.normal(size=(d * d, s_pad)).astype(np.float32))
    lin = torch.as_tensor(rng.normal(size=(d, s_pad)).astype(np.float32))
    nhp[:, num_states:] = 0.0
    lin[:, num_states:] = 0.0
    tier = "high" if passes == 3 else "default"
    folded = temission.fold_quad_params(nhp, lin, torch.zeros(s_pad), tier, num_states)
    assert folded.n_tile == temission.split_n_tile(num_states) == n_tile
    groups, k_lin = temission.split_groups(d, passes)
    k_pad = 4 * len(groups)
    assert folded.k_pad == k_pad and k_pad % temission.SPLIT_KC == 0
    assert (folded.k_lin, folded.pairs.dtype, folded.pairs.shape[0]) == (k_lin, torch.int32,
                                                                          k_pad // 4)
    # Each pair's row, found from the descriptors, holds its folded weight.
    rows = temission.split_row_of(len(groups))
    sym = temission.fold_nhp(nhp, d)
    w_hi, _w_lo, _g, _k = temission.split_weights(sym, lin, passes)
    seen = set()
    for g, (i, j0, flag) in enumerate(groups.tolist()):
        for t in range(4):
            if i < d and i <= j0 + t < d:
                seen.add((i, j0 + t))
                p = temission.sym_pairs(d)
                idx = int(((p[0] == i) & (p[1] == j0 + t)).nonzero())
                assert torch.equal(w_hi[rows[g, t]], sym[idx].to(torch.bfloat16))
            elif i < d or i > d or j0 + t >= d:
                assert not w_hi[rows[g, t]].any()
    assert len(seen) == d * (d + 1) // 2
    cols = -(-s_pad // n_tile) * n_tile
    assert len(folded.weights) == (2 if passes == 3 else 1)
    assert all(tuple(w.shape) == (cols // n_tile, k_pad * n_tile) for w in folded.weights)
    padded = torch.nn.functional.pad(w_hi, (0, cols - s_pad))
    kc = temission.SPLIT_KC
    for t in range(cols // n_tile):
        for c in (0, k_pad // kc - 1):
            chunk = folded.weights[0][t, c * kc * n_tile:(c + 1) * kc * n_tile]
            assert torch.equal(_unlayout(chunk[None], kc, n_tile),
                               padded[c * kc:(c + 1) * kc, t * n_tile:(t + 1) * n_tile])


def test_decoder_folds_only_on_the_card():
    """On the CPU the decoder keeps the unfolded split for the plain
    version and no kernel operand."""
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                            emission_precision="high", device="cpu")
    assert dec._folded is None and dec._nhp_split is not None
