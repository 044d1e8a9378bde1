"""Quadratic-form Gaussian emissions: wrappers of the CUDA kernels
(csrc/emission.cu, csrc/emission_split.cu), their plain PyTorch versions,
and the fused decode.

The kernels compute

    out[n, s] = x2_n . nhp[:, s] + x_n . lin[:, s] + const[s],
    x2_n = vec(x_n x_n^T),

building x2 on chip, never in device memory; padded state columns hold 0.
x2 is symmetric (x2[i*D+j] == x2[j*D+i] exactly), so the kernels run over
its D(D+1)/2 distinct entries against the folded parameters
nhp_sym[(i, j)] = nhp[i*D+j] + nhp[j*D+i] (i < j; the diagonal as it is):
half the products of the unfolded sum. ``fold_quad_params`` prepares a
tier's folded operand once (the decoder caches it); a wrapper given none
folds before the launch.

Three precision tiers, as the JAX package's gaussian_log_pdf_fused has:

- "highest" (``emission``, csrc/emission.cu): float32 throughout. Replaces
  cs304_tpu/ops/pallas/emission.py:_emission_kernel, _emission_kernel_blocked
  and _emission_kernel_selmm (x2_mode "selmm" builds the same x2 on the
  TPU's MXU; here both modes run this one kernel, bitwise the same output).
- "high" (``emission_split``, 3 passes): the quadratic term as three bf16
  tensor-core passes hi.hi + hi.lo + lo.hi over operands split into bf16
  hi / lo, the linear term at float32 accuracy: on the card as the six
  products of x's and lin's bf16 thirds (what Precision.HIGHEST runs on the
  TPU's MXU) riding the same passes, in the plain version in float32.
  Replaces _emission_kernel_high and _emission_kernel_blocked_high.
- "default" (``emission_split``, 1 pass): one bf16 pass hi.hi for the
  quadratic term and one bf16 pass for the linear term: what the TPU runs
  for _emission_kernel at Precision.DEFAULT. The JAX package measured it as
  a negative (0.825 vs 0.9625 exact-sequence on a trained 100-word
  checkpoint) and offers it all the same; so does the port.

Dispatch: a CPU tensor goes to the plain version (unfolded); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ...device import fp32_exact
from ..gaussian import GaussianQuadParams, make_gaussian_quad_params
from ..viterbi import pack_coefs
from . import _build
from .trellis_scanfree import scanfree_decode

LANES = 128
MAX_DIM = 64  # largest D: the kernels' tiles and 8-bit pair indices are sized for it
PASSES = {"high": 3, "default": 1}  # bf16 passes of the split kernel's tiers
SPLIT_TILE = 64  # the split kernel's state tile: s_pad must be a multiple
X2_MODES = ("concat", "selmm")
K_STEP = 16  # K1's folded rows are padded to a multiple of its K step
SPLIT_KC = 32  # the split kernel's K rows a ring stage (its operand's K padding)


def emission_plain(frames, nhp, lin, const):
    """frames (N, D), nhp (D*D, s_pad), lin (D, s_pad), const (s_pad,) ->
    (N, s_pad). x2 is materialized: (N, D*D) floats."""
    fp32_exact()
    n, d = frames.shape
    x2 = (frames[:, :, None] * frames[:, None, :]).reshape(n, d * d)
    return x2 @ nhp + frames @ lin + const


def gaussian_log_pdf_quad_plain(params: GaussianQuadParams, frames):
    """(..., T, D) -> (..., T, S): the plain version of the emission kernel on
    unpadded quadratic-form parameters."""
    d = frames.shape[-1]
    out = emission_plain(frames.reshape(-1, d), params.neg_half_p.T,
                         params.lin, params.const)
    return out.reshape(*frames.shape[:-1], params.const.shape[0])


def emission(frames, nhp, lin, const, num_states: int, s_pad: int,
             folded: FoldedQuad | None = None):
    """frames (N, D) float32 -> (N, s_pad) float32 log-densities of the first
    ``num_states`` states, zeros in columns num_states..s_pad-1. nhp
    (D*D, s_pad), lin (D, s_pad) and const (s_pad,) are zero past
    num_states (pack_quad_params). ``folded``: their "highest" operand from
    fold_quad_params (folded here if None; CUDA only)."""
    if not frames.is_cuda:
        out = emission_plain(frames, nhp, lin, const)
        out[:, num_states:] = 0.0
        return out
    n, d = frames.shape
    f32 = torch.float32
    _check_operands(frames, (("frames", frames, f32, (n, d)),
                             ("nhp", nhp, f32, (d * d, s_pad)),
                             ("lin", lin, f32, (d, s_pad)),
                             ("const", const, f32, (s_pad,))))
    _check_shape(n, d, num_states, s_pad)
    if folded is None:
        folded = fold_quad_params(nhp, lin, const, "highest", num_states)
    out = _launch_quad(frames, folded, num_states, 0)
    emission.launches += 1
    return out


emission.launches = 0


def _launch_quad(frames, folded: FoldedQuad, num_states: int, stage: int):
    """One launch of K1 (stage 0) or of a timing variant of it
    (csrc/emission.cu)."""
    n, d = frames.shape
    w = _check_folded(frames, folded, "highest", d, num_states, folded.s_pad)[0]
    lib = _build.load()
    out = torch.empty((n, folded.s_pad), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_emission_quad(
            frames.data_ptr(), w.data_ptr(), folded.pairs.data_ptr(), out.data_ptr(),
            n, d, num_states, folded.s_pad, folded.k_pad, w.shape[1], folded.n_tile, stage,
            stream,
        )
    _build.check(code, "emission")
    return out


def pack_quad_params(means, covariances, s_pad: int, device=None):
    """Quadratic-form parameters padded to s_pad state columns:
    (nhp (D*D, s_pad), lin (D, s_pad), const (s_pad,)), zero past S."""
    qp = make_gaussian_quad_params(means, covariances, device=device)
    s, dd = qp.neg_half_p.shape
    d = qp.lin.shape[0]
    dev = qp.lin.device
    nhp = torch.zeros((dd, s_pad), dtype=torch.float32, device=dev)
    nhp[:, :s] = qp.neg_half_p.T
    lin = torch.zeros((d, s_pad), dtype=torch.float32, device=dev)
    lin[:, :s] = qp.lin
    const = torch.zeros((s_pad,), dtype=torch.float32, device=dev)
    const[:s] = qp.const
    return nhp, lin, const


def split_hi_lo(x):
    """float32 -> (hi, lo) bfloat16 with hi = bf16(x) and
    lo = bf16(x - float(hi)), both rounded to nearest even (the JAX
    package's _split_hi_lo)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def sym_pairs(d: int, device=None):
    """The (i, j >= i) pairs of a D x D symmetric matrix, in row order
    (i, then j): (i, j) int64 tensors of length D(D+1)/2."""
    return tuple(torch.triu_indices(d, d, device=device))


def fold_nhp(nhp, d: int, k_pad: int | None = None):
    """nhp (D*D, s_pad) -> nhp_sym (k_pad, s_pad): row (i, j) is
    nhp[i*D+i] on the diagonal and nhp[i*D+j] + nhp[j*D+i] (float32) off it,
    rows past D(D+1)/2 zero. The sum, not 2 * nhp[i*D+j]: cholesky_solve
    does not promise a bitwise-symmetric precision matrix."""
    i, j = sym_pairs(d, nhp.device)
    other = torch.where((i != j)[:, None], nhp[j * d + i], 0.0)
    sym = nhp[i * d + j].float() + other.float()
    k_pad = sym.shape[0] if k_pad is None else k_pad
    return torch.cat([sym, sym.new_zeros((k_pad - sym.shape[0], sym.shape[1]))])


def pair_table(d: int, k_pad: int, lin_rows: bool, const_row: bool, device=None):
    """K1's K index: (k_pad,) int16, row k -> i | j << 8, so that K row k of
    x2_sym is x[i] * x[j] over the frame staged with x[D] = 1 and
    x[D+1] = 0: the D(D+1)/2 pairs, then (d, D) for the linear rows, (D, D)
    for the constant row, and (D+1, D+1) for the zero padding."""
    i, j = sym_pairs(d)
    parts_i, parts_j = [i], [j]
    if lin_rows:
        parts_i.append(torch.arange(d))
        parts_j.append(torch.full((d,), d))
    if const_row:
        parts_i.append(torch.tensor([d]))
        parts_j.append(torch.tensor([d]))
    i, j = torch.cat(parts_i), torch.cat(parts_j)
    pad = torch.full((k_pad - i.shape[0],), d + 1)
    i, j = torch.cat([i, pad]), torch.cat([j, pad])
    return (i | (j << 8)).to(torch.int16).to(device)


# Flags of a split-kernel group (split_groups): the group's values are the
# products x_i * x_j themselves, bf16(x_i * x_j), or the residual
# x_i * x_j - bf16(x_i * x_j).
GROUP_PRODUCT, GROUP_ROUND, GROUP_RESIDUAL = 0, 1, 2


def split_groups(d: int, passes: int):
    """The split kernel's K rows, in groups of four: (G, 3) int64 rows
    (i, j0, flag), the group's row t = 0..3 taking the value x[i] * x[j0 + t]
    (flag GROUP_PRODUCT) over the frame staged with x[D] = 1 and zeros past
    it (split_x_stride), so a thread reads x[i] once and x[j0..j0+3] as one
    float4. First the pair groups: for each i, j0 = 4 * (i // 4), ... below
    D, their rows with j < i (the symmetric duplicates) or j >= D weighted
    zero; then the linear rows as groups (D, j0, flag): one set at one pass,
    three at three (GROUP_ROUND, GROUP_RESIDUAL, GROUP_ROUND: x's bf16
    thirds against lin's, fold_quad_params); then zero groups (D+1, 0) to a
    whole number of ring stages. Returns (groups, k_lin), k_lin the first
    linear row."""
    rows = [(i, j0, GROUP_PRODUCT) for i in range(d) for j0 in range(4 * (i // 4), d, 4)]
    k_lin = 4 * len(rows)
    sets = (GROUP_PRODUCT,) if passes == 1 else (GROUP_ROUND, GROUP_RESIDUAL, GROUP_ROUND)
    rows += [(d, j0, flag) for flag in sets for j0 in range(0, d, 4)]
    per_stage = SPLIT_KC // 4
    rows += [(d + 1, 0, GROUP_PRODUCT)] * (-len(rows) % per_stage)
    return torch.tensor(rows, dtype=torch.int64), k_lin


def split_row_of(groups_len: int):
    """(G, 4) int64: the K row of each group's value t. A wgmma K step of 16
    rows holds four groups; lane quad q of a warp holds rows 2q, 2q + 1,
    2q + 8 and 2q + 9 of the step, so group 4s + q's values sit there."""
    g = torch.arange(groups_len)[:, None]
    t = torch.arange(4)[None, :]
    step, q = g // 4, g % 4
    return 16 * step + ((t >> 1) << 3) + (q << 1) + (t & 1)


def split_x_stride(d: int) -> int:
    """The split kernel's staged frame row stride: >= D + 3 (x, 1, zeros up
    to the last group's float4), a multiple of 4 (float4 reads) and 12 mod
    32, so the eight rows of a lane column land on distinct banks."""
    return d + 3 + (12 - (d + 3)) % 32


def split_weights(sym, lin, passes: int):
    """sym = fold_nhp(nhp) (D(D+1)/2, s_pad) float32 and lin (D, s_pad) ->
    the split kernel's weights before the wgmma layout: (W_hi, W_lo)
    bf16 (k_pad, s_pad) in split_groups' row order (W_lo None at one pass),
    with the groups and k_lin. Pair rows: split_hi_lo of nhp_sym; linear
    rows: lin in bf16 (one pass), or lin's thirds (l1, l2, l3 =
    split_thirds(lin)) as [l1; l1; l3] / [l2; l2; 0] against x's bf16 part,
    its residual and its bf16 part again (three passes)."""
    d, s_pad = lin.shape
    groups, k_lin = split_groups(d, passes)
    rows = split_row_of(len(groups))
    i, j0, flag = (groups[:, c:c + 1].expand(-1, 4) for c in range(3))
    j = j0 + torch.arange(4)[None, :]
    k_pad = 4 * len(groups)
    # Pair rows: (i, j) with i <= j < D; the duplicates and j >= D weigh 0.
    live = (i < d) & (j >= i) & (j < d)
    tri = torch.zeros((d, d), dtype=torch.int64)
    ti, tj = sym_pairs(d)
    tri[ti, tj] = torch.arange(ti.shape[0])
    sym_row = torch.where(live, tri[i.clamp(max=d - 1), j.clamp(max=d - 1)], 0)
    hi_sym, lo_sym = split_hi_lo(sym)
    dev = lin.device
    w_hi = torch.zeros((k_pad, s_pad), dtype=torch.bfloat16, device=dev)
    w_lo = torch.zeros_like(w_hi) if passes == 3 else None
    r = rows[live]
    w_hi[r] = hi_sym[sym_row[live].to(dev)]
    if passes == 3:
        w_lo[r] = lo_sym[sym_row[live].to(dev)]
    # Linear rows: (D, j0) groups, j < D.
    lin_live = (i == d) & (j < d)
    set_of = (torch.arange(len(groups))[:, None].expand(-1, 4) * 4 - k_lin) // (
        4 * (-(-d // 4)))
    r, jl, st = rows[lin_live], j[lin_live].to(dev), set_of[lin_live]
    if passes == 1:
        w_hi[r] = lin[jl].to(torch.bfloat16)
    else:
        l1, l2, l3 = split_thirds(lin)
        third = st.to(dev)[:, None] == 2
        w_hi[r] = torch.where(third, l3[jl], l1[jl])
        w_lo[r] = torch.where(third, torch.zeros_like(l2[jl]), l2[jl])
    return w_hi, w_lo, groups, k_lin


def split_thirds(x):
    """float32 -> (t1, t2, t3) bfloat16 with t1 = bf16(x), t2 = bf16(x - t1),
    t3 = bf16(x - t1 - t2): x's mantissa in three bf16 pieces."""
    t1 = x.to(torch.bfloat16)
    r = x - t1.float()
    t2 = r.to(torch.bfloat16)
    return t1, t2, (r - t2.float()).to(torch.bfloat16)


def x2_sym(frames):
    """(N, D) -> (N, D(D+1)/2): x_i * x_j for each pair of sym_pairs."""
    i, j = sym_pairs(frames.shape[1], frames.device)
    return frames[:, i] * frames[:, j]


def emission_folded_plain(frames, nhp_sym, lin, const):
    """The folded product on a materialized x2_sym, float32 throughout:
    x2_sym @ nhp_sym + frames @ lin + const. Tests hold the fold against
    the JAX package with it; no kernel path calls it."""
    fp32_exact()
    x2 = x2_sym(frames)
    return x2 @ nhp_sym[: x2.shape[1]] + frames @ lin + const


class FoldedQuad(NamedTuple):
    """One tier's kernel operand, prepared by fold_quad_params.

    weights: "highest": (W,), W (k_pad, cols) float32 = [nhp_sym; lin;
    const; 0] with cols = s_pad rounded up to n_tile. "high": (W_hi, W_lo),
    "default": (W_hi,): split_weights' rows, zero-padded to cols, each in
    the split kernel's layout (wgmma_layout).
    pairs: "highest": pair_table of the k_pad rows; "high" / "default":
    (k_pad / 4,) int32 group descriptors i | j0 << 8 | flag << 16
    (split_groups).
    n_tile: state columns per block tile.
    k_pad: K rows; k_lin: the first linear row."""

    precision: str
    d: int
    num_states: int
    s_pad: int
    n_tile: int
    pairs: torch.Tensor
    weights: Tuple[torch.Tensor, ...]
    k_pad: int
    k_lin: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def split_n_tile(num_states: int) -> int:
    """The split kernel's state tile: the narrowest wgmma width in (64,
    128, 256) that covers the states, 256 past that, so each frame tile's
    A fragments are built once per tile of up to 256 states."""
    return next((n for n in (64, 128) if num_states <= n), 256)


def wgmma_layout(w, n_tile: int):
    """(k_pad, cols) -> the split kernel's B layout: for each n_tile-wide
    state tile, 8 x 8 core matrices (8 states x 8 K rows, K contiguous),
    ordered (K block, state block): element (k, n) of a tile sits at
    ((k // 8) * (n_tile // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8. Each
    SPLIT_KC rows of a tile are one contiguous chunk: the bytes one bulk
    copy brings into a ring stage, in the layout the stage's wgmma
    descriptors read."""
    k_pad, cols = w.shape
    t = w.reshape(k_pad // 8, 8, cols // n_tile, n_tile // 8, 8)
    return t.permute(2, 0, 3, 4, 1).contiguous().reshape(cols // n_tile, k_pad * n_tile)


def k1_n_tile(num_states: int) -> int:
    """K1's state tile: the narrowest of 64, 128 and 256 that covers the
    states, 256 past that, so each frame tile's x2 is built at most once
    per 256 states."""
    return next((n for n in (64, 128) if num_states <= n), 256)


def fold_quad_params(nhp, lin, const, precision: str, num_states: int) -> FoldedQuad:
    """A tier's folded kernel operand from pack_quad_params' nhp (D*D,
    s_pad), lin (D, s_pad), const (s_pad,) (float32, zero past num_states).
    The decoder calls it once per model; a wrapper given no operand calls it
    before each launch."""
    d, s_pad = lin.shape
    sym = fold_nhp(nhp, d)
    k_sym = sym.shape[0]
    if precision == "highest":
        n_tile = k1_n_tile(num_states)
        k = k_sym + d + 1
        k_pad = _round_up(k, K_STEP)
        cols = _round_up(s_pad, n_tile)
        w = sym.new_zeros((k_pad, cols))
        w[:k_sym, :s_pad] = sym
        w[k_sym:k_sym + d, :s_pad] = lin
        w[k_sym + d, :s_pad] = const
        return FoldedQuad(precision, d, num_states, s_pad, n_tile,
                          pair_table(d, k_pad, True, True, lin.device), (w,), k_pad, k_sym)
    if precision not in PASSES:
        raise ValueError(f"unknown precision {precision!r}")
    passes = PASSES[precision]
    w_hi, w_lo, groups, k_lin = split_weights(sym, lin, passes)
    n_tile = split_n_tile(num_states)
    cols = _round_up(s_pad, n_tile)
    halves = (w_hi,) if w_lo is None else (w_hi, w_lo)
    weights = tuple(wgmma_layout(torch.nn.functional.pad(h, (0, cols - s_pad)), n_tile)
                    for h in halves)
    desc = (groups[:, 0] | (groups[:, 1] << 8) | (groups[:, 2] << 16)).to(torch.int32)
    return FoldedQuad(precision, d, num_states, s_pad, n_tile, desc.to(lin.device), weights,
                      4 * len(groups), k_lin)


def emission_split_plain(frames, nhp_hi, nhp_lo, lin, const, passes: int):
    """The plain version of the split kernel: frames (N, D) float32, nhp_hi
    / nhp_lo (D*D, s_pad) bfloat16 (nhp_lo unused at 1 pass), lin (D, s_pad)
    and const (s_pad,) float32 -> (N, s_pad). The bf16 operands are
    multiplied in float32 matmuls with TF32 off, where their products are
    exact; x2 is materialized."""
    fp32_exact()
    n, d = frames.shape
    x2 = (frames[:, :, None] * frames[:, None, :]).reshape(n, d * d)
    x2_hi, x2_lo = split_hi_lo(x2)
    quad = x2_hi.float() @ nhp_hi.float()
    if passes == 3:
        quad = (quad + x2_hi.float() @ nhp_lo.float()) + x2_lo.float() @ nhp_hi.float()
        lin_term = frames @ lin
    else:
        lin_term = frames.to(torch.bfloat16).float() @ lin.to(torch.bfloat16).float()
    return quad + lin_term + const


def _check_operands(frames, specs):
    """Device, dtype, shape and contiguity of a kernel's operands:
    specs = ((name, tensor, dtype, shape), ...)."""
    for name, t, dtype, shape in specs:
        if not t.is_cuda or t.device != frames.device:
            raise ValueError(f"{name} must be on {frames.device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_shape(n, d, num_states, s_pad):
    if not (1 <= d <= MAX_DIM and n >= 1 and 1 <= num_states <= s_pad):
        raise ValueError(
            f"unsupported emission shape N={n} D={d} S={num_states} "
            f"s_pad={s_pad} (need N >= 1, 1 <= D <= {MAX_DIM}, S <= s_pad)"
        )


def _check_folded(frames, folded: FoldedQuad, precision: str, d: int,
                  num_states: int, s_pad: int):
    """A folded operand matches the call: tier, shapes, device, layout.
    Returns its weights."""
    if not isinstance(folded, FoldedQuad) or folded.precision != precision:
        raise ValueError(f"folded operand is not the {precision!r} tier's")
    if (folded.d, folded.num_states, folded.s_pad) != (d, num_states, s_pad):
        raise ValueError(
            f"folded operand is for D={folded.d} S={folded.num_states} "
            f"s_pad={folded.s_pad}, not D={d} S={num_states} s_pad={s_pad}")
    k_pad = folded.k_pad
    if precision == "highest":
        shapes = [(k_pad, _round_up(s_pad, folded.n_tile))]
        dtype = torch.float32
        specs = [("pairs", folded.pairs, torch.int16, (k_pad,))]
    else:
        halves = 2 if PASSES[precision] == 3 else 1
        shapes = [(_round_up(s_pad, folded.n_tile) // folded.n_tile,
                   k_pad * folded.n_tile)] * halves
        dtype = torch.bfloat16
        specs = [("pairs", folded.pairs, torch.int32, (k_pad // 4,))]
    if len(folded.weights) != len(shapes):
        raise ValueError(f"folded operand has {len(folded.weights)} weights, "
                         f"want {len(shapes)}")
    specs += [(f"weights[{i}]", w, dtype, shape)
              for i, (w, shape) in enumerate(zip(folded.weights, shapes))]
    _check_operands(frames, specs)
    step = K_STEP if precision == "highest" else SPLIT_KC
    if k_pad % step or any(t.data_ptr() % 16 for t in (folded.pairs, *folded.weights)):
        raise ValueError(f"folded rows must be a multiple of {step} and the "
                         "folded tensors 16-byte aligned")
    return folded.weights


def emission_split(frames, nhp_hi, nhp_lo, lin, const, num_states: int,
                   s_pad: int, passes: int, folded: FoldedQuad | None = None):
    """The "high" (passes=3) or "default" (passes=1) tier: frames (N, D)
    float32 -> (N, s_pad) float32, zeros in columns num_states..s_pad-1.
    nhp_hi / nhp_lo (D*D, s_pad) bfloat16 from split_hi_lo of
    pack_quad_params' nhp (nhp_lo may be None at 1 pass); lin (D, s_pad),
    const (s_pad,) float32. ``folded``: the tier's operand from
    fold_quad_params (CUDA only; nhp_hi / nhp_lo may then be None); if None,
    nhp_hi + nhp_lo is folded here."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if not frames.is_cuda:
        out = emission_split_plain(frames, nhp_hi, nhp_lo, lin, const, passes)
        out[:, num_states:] = 0.0
        return out
    n, d = frames.shape
    bf16 = torch.bfloat16
    specs = [("frames", frames, torch.float32, (n, d)),
             ("lin", lin, torch.float32, (d, s_pad)),
             ("const", const, torch.float32, (s_pad,))]
    if folded is None:  # the halves are folded here, so they must be whole
        specs.append(("nhp_hi", nhp_hi, bf16, (d * d, s_pad)))
        if passes == 3:
            if nhp_lo is None:
                raise ValueError("the 3-pass tier needs nhp_lo")
            specs.append(("nhp_lo", nhp_lo, bf16, (d * d, s_pad)))
    _check_operands(frames, specs)
    _check_shape(n, d, num_states, s_pad)
    if s_pad % SPLIT_TILE:
        raise ValueError(f"the split kernel needs s_pad a multiple of {SPLIT_TILE}")
    tier = "high" if passes == 3 else "default"
    if folded is None:
        nhp = nhp_hi.float() if passes == 1 else nhp_hi.float() + nhp_lo.float()
        folded = fold_quad_params(nhp, lin, const, tier, num_states)
    out = _launch_split(frames, const, folded, num_states, passes, 0)
    emission_split.launches += 1
    return out


emission_split.launches = 0


def _launch_split(frames, const, folded: FoldedQuad, num_states: int, passes: int,
                  stage: int):
    """One launch of K1-split (stage 0) or of a timing variant of it
    (csrc/emission_split.cu)."""
    n, d = frames.shape
    tier = "high" if passes == 3 else "default"
    weights = _check_folded(frames, folded, tier, d, num_states, folded.s_pad)
    lib = _build.load()
    out = torch.empty((n, folded.s_pad), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_emission_split(
            frames.data_ptr(), weights[0].data_ptr(),
            weights[1].data_ptr() if passes == 3 else None, folded.pairs.data_ptr(),
            const.data_ptr(), out.data_ptr(), n, d, num_states, folded.s_pad, folded.k_pad,
            folded.k_lin, folded.n_tile, passes, stage, stream,
        )
    _build.check(code, "emission_split")
    return out


# Timing variants of each tier's kernel, each leaving out one stage:
# "const_x2" builds K1's x2 chunk once and reuses it (FMAs and W loads
# alone); "build" runs the split kernel's A build without its wgmmas,
# "wgmma" its wgmmas on a constant fragment without the build, "no_linear"
# skips the "high" tier's linear rows, "io" only reads the frames and
# writes the emissions.
STAGES = {"highest": {"const_x2": 1},
          "high": {"build": 1, "wgmma": 2, "no_linear": 3, "io": 4},
          "default": {"build": 1, "wgmma": 2, "io": 4}}


def emission_stage(frames, const, folded: FoldedQuad, stage: str):
    """One launch of the timing variant ``stage`` (STAGES) of the folded
    operand's tier: chip_smoke.py's stage split reads it; never counted in
    ``launches``."""
    code = STAGES[folded.precision][stage]
    n, d = frames.shape
    f32 = torch.float32
    _check_operands(frames, (("frames", frames, f32, (n, d)),
                             ("const", const, f32, (folded.s_pad,))))
    if folded.precision == "highest":
        return _launch_quad(frames, folded, folded.num_states, code)
    return _launch_split(frames, const, folded, folded.num_states,
                         PASSES[folded.precision], code)


def tier_emission(frames, nhp, lin, const, num_states: int, s_pad: int,
                  precision: str = "highest", nhp_split=None,
                  folded: FoldedQuad | None = None):
    """One precision tier's emissions on packed parameters: "highest" runs
    the float32 kernel, "high" / "default" the split kernel. On a CPU tensor
    nhp_split, the cached split_hi_lo(nhp), saves the plain version's split;
    on the card ``folded``, the cached fold_quad_params(..., precision), saves
    the fold (folded from nhp here if None)."""
    if precision == "highest":
        return emission(frames, nhp, lin, const, num_states, s_pad, folded)
    if precision not in PASSES:
        raise ValueError(f"unknown precision {precision!r}")
    if frames.is_cuda:  # the kernel reads the folded operand only
        nhp_hi = nhp_lo = None
        if folded is None:
            folded = fold_quad_params(nhp, lin, const, precision, num_states)
    else:
        nhp_hi, nhp_lo = nhp_split if nhp_split is not None else split_hi_lo(nhp)
    return emission_split(frames, nhp_hi, nhp_lo, lin, const, num_states,
                          s_pad, PASSES[precision], folded)


def gaussian_log_pdf_fused(means, covariances, frames_flat, s_pad: int = LANES,
                           precision: str = "highest", x2_mode: str = "concat"):
    """(N, D) frames -> (N, s_pad) emission log-densities, states padded with
    zero columns to s_pad (a multiple of 128). precision "highest", "high"
    or "default"; x2_mode "concat" or "selmm" (both build x2 the same way
    here and give bitwise the same output; as in the JAX package, it has no
    effect past 128 states or at "high")."""
    if x2_mode not in X2_MODES:
        raise ValueError(f"unknown x2_mode {x2_mode!r}; expected one of {X2_MODES}")
    if s_pad % LANES:
        raise ValueError(f"s_pad {s_pad} must be a multiple of {LANES}")
    s = int(means.shape[0])
    if s > s_pad:
        raise ValueError(f"{s} states do not fit s_pad={s_pad}")
    nhp, lin, const = pack_quad_params(means, covariances, s_pad,
                                       device=frames_flat.device)
    return tier_emission(frames_flat.contiguous(), nhp, lin, const, s, s_pad,
                         precision)


def decode_batch_fused(
    means, covs, log_a, lower_of_state, is_entry, is_exit, penalty,
    batch_feats, lengths, quirk_backtrace: bool = True,
    precision: str = "highest",
):
    """The fused decode: an emission kernel of the precision tier on
    (B*T, D) frames, then the scan-free trellis pair on the padded
    (B, T, s_pad) emissions. batch_feats (B, T, D) float32, lengths (B,) ->
    (scores (B,), paths (B, T) int32), on batch_feats' device."""
    b, t_total, d = batch_feats.shape
    s = int(means.shape[0])
    s_pad = -(-s // LANES) * LANES
    dev = batch_feats.device
    log_b = gaussian_log_pdf_fused(
        means, covs, batch_feats.reshape(b * t_total, d), s_pad=s_pad,
        precision=precision,
    ).reshape(b, t_total, s_pad)
    coefs = pack_coefs(log_a, lower_of_state, is_entry, is_exit, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return scanfree_decode(log_b, coefs, penalty, lengths, quirk_backtrace)
