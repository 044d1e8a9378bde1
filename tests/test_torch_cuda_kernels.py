"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the quad-form emission kernel and its split "high" / "default" tiers
(within rtol 1e-4 / atol 1e-3, as tests/test_pallas_emission.py holds the
Pallas kernel; both run the folded operand, the plain versions the unfolded
one; N = 1, N off the frame tile, D = 1 and D = 64 included), the scan-free
trellis (the decode-mode kernel, the backpointer-mode forward and K2-bt;
T = 1280, an odd row stride, 98 and 5003 states, and the global-codes
branch at T = 4000 and at 503 states included), the sentence topology of
the same kernel (the training path: ONE decode-mode launch, no
backpointer-mode launch and no K2-bt; its backpointer mode; 2100 states and
a global-codes T included), the dense trellis on each of its branches
(trans resident in one CTA, in a cluster's CTAs, or streamed; B not a
multiple of the utterances a block or cluster carries, T = 1, length-0 and
-1 rows, signed zeros; scores, full paths, alphas with their signs of zero
and backpointers bitwise equal), and the K5/K6 wrappers; the serving pool's
step (the stream mode on each team size and ring dtype, a zero penalty and
ties; 373, 2053 and 8188 states, 16 and 32 frames a launch, rows past T_max
and rows of valid 0; K4's dense step; K2-bt walking int8 and int32 ring
slices in place),
the single-stream decoder on the card, and the serving entry points'
default device; the Baum-Welch sentence forward-backward (FB: every cell
bitwise its plain version; length-0 and -1 rows, T = 1, 1 to 2100 states,
finals the band reaches), its E-step mode (gamma, xi sums, ll on the same
cases, each with finite ll in at least half its rows: every cell bitwise)
and one fused Baum-Welch iteration launching the E-step mode and not FB;
the search modes (the LM and BEAM decode modes and the LM
stream mode, bitwise their plain versions; every case with finite scores in
at least half its rows; 5003 states with the codes in the global scratch;
the beam at 2053 and 5003 states, a beam of 0, zero penalties, and a step
whose every exit the beam prunes;
the LM entry update at W = 1 and 31 / 32 / 33, W off the four-source
groups, steps whose every exit is -inf, signed-zero ties across source
words, and each of the table's register / shared / global branches,
asserted through lm_table_branch; a NaN frame keeping every source word in
range, without a fault) and the bigram and beam decoders
launching their modes and never the plain trellis; the trainer's tie
pooling (bitwise a sequential scatter-add) and two tied trainings, Viterbi
and Baum-Welch, bitwise equal; the constrained searches' kernels (PLANES:
counted decoding N = 1..7 and a range, the menu grammar and position
grammars; DURATION: floors and ceilings) bitwise their plain versions in
scores and finite paths at 58, 503 and 5003 states, integer ties, T = 1,
lengths 0, -1 and past T, -inf emissions, a column slice read at its row
stride, the team, cluster and simple branches (B = 1, a cluster of CTAs,
8 slots at 503 and 5003 states, the simple branch on K2-bt's widest row
and its forward's walk past it, each team case beside the forced simple
branch), a cross move with two source planes and a
duration advance whose sums tie under a -3e9 penalty, and the decoder's
counted / grammar / duration decodes launching them and never a plain
trellis; the posterior and n-best searches' kernels (LSUM: the same -inf
cells, the rest within 1e-5 * max(1, |x|) of its plain version; LMAX and
KBEST bitwise; 58, 503 and 5003 states, single-state words under both
penalty cases, length-1 and -2 rows, pools of 1, 31, 32 and 33 members,
KBEST at K = 1, 2, 4, 6, 8, 16, 32 and 33, T = 1; LSUM, LMAX and KBEST on
their team branch and on the forced simple branch, LMAX with signs of zero,
at 1503, 3003 and 8188 states too and on every build of its team branch)
and the decoder's
confidences, n-best, forward lattice and keyword passes launching them
with no plain loop on the card; the transcribe script (plain and with
--confidence --timings) with --device cuda and --device cpu on the same
WAVs: the same printed lines, the decode kernel launched on the card only;
FBD, the dense forward-backward (csrc/forward_backward.cu), bitwise its plain
version in its forward, backward and posteriors modes on each build (S = 1
to 128 at every bucket's edges, 4 and 2 sequences a warp, T = 1 and rows of
700, lengths 0, 1 and past T, a dead column, a learned matrix with a dead
row and column, an unreachable final; the plan the library's), the
forward_backward ops and word Baum-Welch launching it once a call and never
the plain loop; K3's backpointer mode with a t = 0 seed bitwise its plain
version; lattice rescoring's arc scores (one K3 launch) and the assoc
decode's backtrace (one K2-bt launch) equal to the CPU's.

Every comparison with a plain version runs on poisoned memory
(tests/torch_poison.py): the wrapper is called once under each of two fill
patterns of what torch.empty returns (NaN / -12345 / 0xFF, then
0x7F7F7F7F / 0x5A5A5A5A / 0xA5), whose results must agree in every bit, and
the plain version under a third (0xC3 bytes); a pool step runs on a copy of
the pool's state under each pattern with the ring rows it writes poisoned
first. A cell a kernel leaves unwritten then differs whatever the plain
version holds there.

These are chip_smoke.py's phases 3-4, 7, 11-13, 17, 19-20, 22, 28 and 30-32 at small sizes. Every test needs a card
and skips without one; there is no CPU mode of a CUDA kernel. The machine
with the card has no JAX, so run this file without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cs304_tpu_torch.models.hmm import (
    WordHMM,
    flagship_composite,
    flagship_models,
    stack_word_models,
    uniform_forward_log_a,
)
from cs304_tpu_torch.models.train_fused import _banded_trellis_batch
from cs304_tpu_torch.ops.cuda import _build
from cs304_tpu_torch.ops.cuda import emission as em
from cs304_tpu_torch.ops.cuda import trellis_banded as tb
from cs304_tpu_torch.ops.cuda import trellis_dense as tdn
from cs304_tpu_torch.ops.cuda import trellis_fast as tfast
from cs304_tpu_torch.ops.cuda import trellis_lanes as tlanes
from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
from cs304_tpu_torch.ops.gaussian import gaussian_log_pdf_quad, make_gaussian_quad_params
from cs304_tpu_torch.ops.viterbi import (
    banded_sentence_forward,
    dense_forward,
    first_max,
    forward_fast,
    pack_coefs,
    viterbi_composite_batch,
    viterbi_composite_batch_fast,
)
from torch_poison import (
    KERNEL_POISONS,
    PLAIN_POISON,
    differing_cells,
    kernel_runs,
    plain_run,
    poison_,
    poisoned,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _composite(num_words, d=39, seed=0):
    """num_words 5-state words + a 3-state silence, flagship-like Gaussians."""
    rng = np.random.default_rng(seed)
    models = []
    for i in range(num_words + 1):
        s = 3 if i == num_words else 5
        a = rng.normal(size=(s, d, 8)).astype(np.float32) * 0.1
        models.append(WordHMM(
            label="S" if i == num_words else f"w{i}",
            means=rng.normal(size=(s, d)).astype(np.float32),
            covariances=a @ np.transpose(a, (0, 2, 1)) + 0.5 * np.eye(d, dtype=np.float32),
            log_a=uniform_forward_log_a(s)))
    return stack_word_models(models, penalty=-100.0)


def _emission_composite(num_words, d):
    """_composite(num_words, d), or for "SK116" the 116 columns the quad
    tiers decode a K=2 GMM of the 58-state composite over (each Gaussian
    twice, means jittered per component)."""
    if num_words != "SK116":
        return _composite(num_words, d)
    comp = _composite(11, d)
    rng = np.random.default_rng(6)
    means = np.concatenate([comp.means + 0.1 * rng.normal(size=comp.means.shape)
                            for _ in range(2)]).astype(np.float32)
    return SimpleNamespace(num_states=2 * comp.num_states, means=means,
                           covariances=np.concatenate([comp.covariances] * 2))


# num_words, N, D: the flagship, 503 states, small D, N = 1, D = 1, D = 64
# at 58 and at 503 states (the split kernel's widest tiles at the largest
# D), 5003 states, the K=2 GMM width (S*K = 116); N = 1000 and 333 are off
# every frame tile.
EMISSION_CASES = [(11, 1000, 39), (100, 200, 39), (1, 77, 5), (11, 1, 39), (11, 333, 1),
                  (11, 500, 64), (1000, 64, 39), ("SK116", 1000, 39), (100, 200, 64)]


@pytest.mark.parametrize("num_words,n,d", EMISSION_CASES)
def test_emission_kernel_matches_plain(dev, num_words, n, d):
    comp = _emission_composite(num_words, d)
    s = comp.num_states
    s_pad = -(-s // 128) * 128
    frames = torch.randn((n, d), generator=torch.Generator().manual_seed(n)).to(dev)
    packed = em.pack_quad_params(comp.means, comp.covariances, s_pad, device=dev)
    before = em.emission.launches
    runs = kernel_runs(em.emission, frames, *packed, num_states=s, s_pad=s_pad)
    assert em.emission.launches == before + 2  # one launch a poison
    want = plain_run(em.emission_plain, frames, *packed)
    torch.cuda.synchronize()
    for got in runs:
        assert got.shape == (n, s_pad)
        torch.testing.assert_close(got[:, :s], want[:, :s], rtol=1e-4, atol=1e-3)
        assert not got[:, s:].any()
    # Unpadded (s_pad == S) through gaussian_log_pdf_quad.
    qp = make_gaussian_quad_params(comp.means, comp.covariances, device=dev)
    for unpadded in kernel_runs(gaussian_log_pdf_quad, qp, frames.reshape(1, n, d)):
        torch.testing.assert_close(unpadded[0], want[:, :s], rtol=1e-4, atol=1e-3)


def _trellis_case(dev, comp, log_b, lengths):
    """The decode-mode kernel (one launch, no other trellis kernel), the
    backpointer-mode forward and K2-bt, each bitwise its plain version."""
    coefs = pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry,
                       comp.is_exit, device=dev)
    counters = (tsf.scanfree_decode, tsf.trellis_forward, tsf.trellis_backtrace)
    before = [c.launches for c in counters]
    runs = kernel_runs(tsf.scanfree_decode, log_b, coefs, comp.penalty, lengths)
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 0, 0]
    want = plain_run(
        viterbi_composite_batch_fast, log_b[..., : comp.num_states].contiguous(), comp.log_a,
        comp.lower_of_state, comp.is_entry, comp.is_exit, comp.penalty, lengths)
    fwd_runs = kernel_runs(tsf.trellis_forward, log_b, coefs, comp.penalty, lengths)
    want_fwd = plain_run(forward_fast, log_b, coefs, comp.penalty, lengths)
    scores, best = first_max(want_fwd[0], coefs[5] > 0)
    bt_runs = kernel_runs(tsf.trellis_backtrace, want_fwd[1], best, lengths)
    torch.cuda.synchronize()
    for got, (alpha, bp), paths in zip(runs, fwd_runs, bt_runs):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(alpha, want_fwd[0]) and torch.equal(bp, want_fwd[1])
        assert torch.equal(scores, want[0]) and torch.equal(paths, want[1])


def banded_problem(gen, b, t, s, ties=False, degenerate=False, zero_length=False):
    """A K3 input on the generator's device: log_b (B, T, S), c0/c1/c2 with
    -inf sprinkled in, lengths and ragged n_states."""
    dev = gen.device

    def rand(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return torch.round(2 * x) if ties else x

    log_b = rand(b, t, s)
    c0, c1, c2 = (0.5 * rand(b, s) for _ in range(3))
    c1[:, :1] = float("-inf")
    c2[:, :2] = float("-inf")
    for c in (c0, c1, c2):
        c[torch.rand((b, s), generator=gen, device=dev) < 0.15] = float("-inf")
    if degenerate:
        c0[:, 0] = float("-inf")
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    if zero_length:
        lengths[1::3] = 0
    n_states = torch.randint(max(1, s - 8), s + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32)
    return log_b, c0, c1, c2, lengths, n_states


BANDED = {  # case -> (B, T, S, options); "training" is the trainer's shape
    "banded-training": (896, 160, 59, {}),
    "banded-ties": (64, 40, 59, {"ties": True}),
    "banded-degenerate": (33, 50, 59, {"degenerate": True}),
    "banded-zero-length": (33, 50, 59, {"zero_length": True, "ties": True}),
    "banded-t1": (5, 1, 59, {}),
    "banded-503": (8, 40, 503, {}),
    "banded-2100": (4, 40, 2100, {}),  # teams of 9 warps, 8 states a lane
    "banded-t4000": (6, 4000, 59, {}),  # codes in a global scratch
}


def _banded_case(dev, case):
    """The sentence trellis: the training path is ONE launch of the decode
    mode (no backpointer-mode launch, no K2-bt), bitwise
    _banded_trellis_batch; the backpointer mode is bitwise
    banded_sentence_forward."""
    gen = torch.Generator(device=dev).manual_seed(1)
    b, t, s, opts = BANDED[case]
    prob = banded_problem(gen, b, t, s, **opts)
    assert (tsf.codes_scratch_bytes(b, t, s) > 0) == (case == "banded-t4000")
    counters = (tb.banded_decode, tb.banded_forward, tsf.trellis_backtrace)
    before = [c.launches for c in counters]
    runs = kernel_runs(tb.viterbi_banded_batch_scanfree, *prob)
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 0, 0]
    want = plain_run(_banded_trellis_batch, *prob)
    fwd_runs = kernel_runs(tb.banded_forward, *prob[:5])
    want_fwd = plain_run(banded_sentence_forward, *prob[:5])
    torch.cuda.synchronize()
    for got, (alpha, bp) in zip(runs, fwd_runs):
        for g, w in zip((*got, alpha, bp), (*want, *want_fwd)):
            assert torch.equal(g, w)
        assert torch.equal(torch.signbit(alpha), torch.signbit(want_fwd[0]))


# Cases whose decode codes go to a global scratch: T = 4000 at 58 states
# (one-warp teams, four a block), 503 states at T = 500 (a team of 4 warps,
# 4 states a lane) and 5003 states at T = 60 (20 warps, 8 states a lane;
# at T = 30 their codes still fit in shared memory). "98" is a one-warp
# team of 4 states a lane, the K6 wrapper's range.
GLOBAL_CODES = {"t4000", "503-t500", "5003-t60"}


@pytest.mark.parametrize("case", ["flagship", "503", "ties", "b5-t1", "b5-t2", "padded",
                                  "t1280", "ld-odd", "5003", "98", "t4000", "503-t500",
                                  "5003-t60", *BANDED])
def test_trellis_pair_is_bitwise_plain(dev, case):
    if case in BANDED:
        _banded_case(dev, case)
        return
    gen = torch.Generator(device=dev).manual_seed(0)
    comp = {"503": lambda: _composite(100), "503-t500": lambda: _composite(100),
            "5003": lambda: _composite(1000), "5003-t60": lambda: _composite(1000),
            "98": lambda: _composite(19)}.get(case, flagship_composite)()
    s = comp.num_states
    b, t = {"b5-t1": (5, 1), "b5-t2": (5, 2), "503": (8, 40), "5003": (4, 30),
            "t1280": (6, 1280), "98": (9, 50), "t4000": (6, 4000),
            "503-t500": (4, 500), "5003-t60": (2, 60)}.get(case, (33, 50))
    assert (tsf.codes_scratch_bytes(b, t, s) > 0) == (case in GLOBAL_CODES)
    ld = {"padded": 128, "ld-odd": s + 1}.get(case, s)  # 128: the emission kernel's layout
    if case == "ties":
        log_b = torch.randint(-3, 1, (b, t, s), generator=gen, device=dev).float()
    else:
        log_b = 3 * torch.randn((b, t, ld), generator=gen, device=dev)
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0] = 1  # a length-1 row
    _trellis_case(dev, comp, log_b, lengths)


@pytest.mark.parametrize("penalty", [-0.0, 0.0])
def test_trellis_zero_penalty_keeps_the_sign_of_zero(dev, penalty):
    """Every transition and emission -0.0: exits tie at zeros, and with a
    zero penalty the best exit's sign of zero reaches alpha, so the decode
    kernel must take better()'s value, not a max's."""
    comp = flagship_composite()
    log_a = np.where(np.isfinite(comp.log_a), np.float32(-0.0), comp.log_a).astype(np.float32)
    topo = (log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    coefs = pack_coefs(*topo, device=dev)
    log_b = torch.full((8, 20, comp.num_states), -0.0, device=dev)
    lengths = torch.full((8,), 20, dtype=torch.int32, device=dev)
    runs = kernel_runs(tsf.scanfree_decode, log_b, coefs, penalty, lengths)
    fwd_runs = kernel_runs(tsf.trellis_forward, log_b, coefs, penalty, lengths)
    want = plain_run(viterbi_composite_batch_fast, log_b, *topo, penalty, lengths)
    want_fwd = plain_run(forward_fast, log_b, coefs, penalty, lengths)
    torch.cuda.synchronize()
    for got, (alpha, bp) in zip(runs, fwd_runs):
        for g, w in zip((*got, alpha, bp), (*want, *want_fwd)):
            assert torch.equal(g, w)
        # torch.equal holds -0.0 == 0.0: compare the signs too.
        assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))
        assert torch.equal(torch.signbit(alpha), torch.signbit(want_fwd[0]))


def test_scanfree_decode_codes_branch_by_shape(dev):
    """Shared-memory codes at the flagship (T = 201 and 1280), 98 states,
    503 states at T = 201 and 5003 at T = 30; a global scratch of B * T code
    rows (32 lanes * k states * W warps bytes each) and B * T int16 best
    exits at 5003 states from T = 40, at T = 4000 with 58 states and at
    T = 500 with 503."""
    assert tsf.codes_scratch_bytes(512, 201, 58) == 0
    assert tsf.codes_scratch_bytes(6, 1280, 58) == 0
    assert tsf.codes_scratch_bytes(16, 201, 98) == 0
    assert tsf.codes_scratch_bytes(16, 201, 503) == 0
    assert tsf.codes_scratch_bytes(4, 30, 5003) == 0
    assert tsf.codes_scratch_bytes(8, 201, 5003) == 8 * 201 * (5120 + 2)
    assert tsf.codes_scratch_bytes(2, 60, 5003) == 2 * 60 * (5120 + 2)
    assert tsf.codes_scratch_bytes(6, 4000, 58) == 6 * 4000 * (64 + 2)
    assert tsf.codes_scratch_bytes(4, 500, 503) == 4 * 500 * (512 + 2)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    comp = flagship_composite()
    coefs = pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry,
                       comp.is_exit, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        tsf.trellis_forward(torch.zeros((2, 3, 58), dtype=torch.float64, device=dev),
                            coefs, -1.0, lengths)
    with pytest.raises(ValueError):
        tsf.trellis_forward(torch.zeros((2, 3, 40), device=dev), coefs, -1.0, lengths)
    big = torch.zeros((8, tsf.MAX_STATES + 1), device=dev)
    with pytest.raises(ValueError):
        tsf.trellis_forward(torch.zeros((1, 2, tsf.MAX_STATES + 1), device=dev), big,
                            -1.0, lengths[:1])
    packed = em.pack_quad_params(comp.means, comp.covariances, 128, device=dev)
    with pytest.raises(ValueError):
        em.emission(torch.zeros((39, 4), device=dev).T, *packed,
                    num_states=58, s_pad=128)
    # K3: more states than the kernel takes, a wrong dtype, a non-contiguous
    # input, and tensors on different devices.
    gen = torch.Generator(device=dev).manual_seed(2)
    log_b, c0, c1, c2, lens, _n = banded_problem(gen, 2, 3, 59)
    wide = torch.zeros((1, 2, tb.MAX_STATES + 1), device=dev)
    cw = torch.zeros((1, tb.MAX_STATES + 1), device=dev)
    with pytest.raises(ValueError):
        tb.banded_forward(wide, cw, cw, cw, lens[:1])
    with pytest.raises(TypeError):
        tb.banded_forward(log_b.double(), c0, c1, c2, lens)
    with pytest.raises(ValueError):
        tb.banded_forward(log_b.transpose(0, 1).contiguous().transpose(0, 1),
                          c0, c1, c2, lens)
    with pytest.raises(ValueError):
        tb.banded_forward(log_b, c0, c1, c2, lens.cpu())


def test_decoder_scanfree_matches_fast_backend_on_card(dev):
    from cs304_tpu_torch.data.batching import make_signals
    from cs304_tpu_torch.models.decoder import ContinuousDecoder

    signals = list(make_signals(6, 1.5, seed=11))
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                            device="cuda")
    assert dec.backend == "scanfree"
    assert dec._folded.precision == "highest"  # folded once, at construction
    plain = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                              backend="fast", device="cuda")
    launches = em.emission.launches
    got = dec.predict_signal_batch(signals)
    assert em.emission.launches > launches
    assert got == plain.predict_signal_batch(signals)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("num_words,n,d", EMISSION_CASES)
def test_split_emission_kernel_matches_plain(dev, precision, num_words, n, d):
    comp = _emission_composite(num_words, d)
    s = comp.num_states
    s_pad = -(-s // 128) * 128
    gen = torch.Generator().manual_seed(n)
    frames = (3 * torch.randn((n, d), generator=gen)).to(dev)
    nhp, lin, const = em.pack_quad_params(comp.means, comp.covariances, s_pad, device=dev)
    nhp_hi, nhp_lo = em.split_hi_lo(nhp)
    passes = em.PASSES[precision]
    before = em.emission_split.launches
    runs = kernel_runs(em.tier_emission, frames, nhp, lin, const, s, s_pad, precision)
    assert em.emission_split.launches == before + 2  # one launch a poison
    want = plain_run(em.emission_split_plain, frames, nhp_hi, nhp_lo, lin, const, passes)
    torch.cuda.synchronize()
    for got in runs:
        assert got.shape == (n, s_pad)
        torch.testing.assert_close(got[:, :s], want[:, :s], rtol=1e-4, atol=1e-3)
        assert not got[:, s:].any()
    # x2_mode "selmm" is the same kernel: bitwise the same output.
    args = (comp.means, comp.covariances, frames)
    for tier in ("highest", precision):
        a = plain_run(em.gaussian_log_pdf_fused, *args, s_pad=s_pad, precision=tier)
        for b in kernel_runs(em.gaussian_log_pdf_fused, *args, s_pad=s_pad, precision=tier,
                             x2_mode="selmm"):
            assert torch.equal(a, b)


# The operand cases of tests/test_torch_emission_fold.py's
# test_split_operand_shape: (D, passes, states, state tile).
SPLIT_OPERAND_CASES = [(39, 3, 50, 64), (39, 1, 116, 128), (64, 3, 503, 256),
                       (64, 1, 5003, 256), (7, 3, 58, 64)]


@pytest.mark.parametrize("d,passes,num_states,n_tile", SPLIT_OPERAND_CASES)
def test_split_ring_holds_three_stages(dev, d, passes, num_states, n_tile):
    """The split kernel sizes its B ring from what one block's shared
    memory holds at the operand's K rows and D: at least the 3 stages its
    launch needs, at full width (no narrower fallback), and it launches."""
    s_pad = -(-num_states // 128) * 128
    gen = torch.Generator().manual_seed(d)
    nhp = torch.randn((d * d, s_pad), generator=gen)
    lin = torch.randn((d, s_pad), generator=gen)
    nhp[:, num_states:] = 0.0
    lin[:, num_states:] = 0.0
    tier = "high" if passes == 3 else "default"
    const = torch.zeros(s_pad, device=dev)
    folded = em.fold_quad_params(nhp.to(dev), lin.to(dev), const, tier, num_states)
    assert folded.n_tile == n_tile
    stages = _build.load().cs304_emission_split_stages(n_tile, d, folded.k_pad, passes)
    assert 3 <= stages <= 16
    frames = torch.randn((100, d), generator=gen).to(dev)
    for got in kernel_runs(em.emission_split, frames, None, None, lin.to(dev), const,
                           num_states, s_pad, passes, folded=folded):
        assert got.shape == (100, s_pad) and bool(torch.isfinite(got).all())


# The dense kernel's branch by state count: trans resident in one CTA up to
# 240 states, a 64-column slice resident in each CTA of a cluster up to 512,
# each CTA's slice streamed from L2 past that.
DENSE_BRANCH = {1: "block", 58: "block", 64: "block", 220: "block", 240: "block",
                241: "cluster", 300: "cluster", 503: "cluster", 512: "cluster",
                513: "streamed", 1000: "streamed", 8192: "streamed"}

# case -> (S, B, T, options): random trans with -inf sprinkled in and an all
# -inf column; "ragged": B not a multiple of the utterances a block or
# cluster carries; "short": rows of length 0 and 1; "zeros": every value a
# zero of random sign.
DENSE_RANDOM = {
    "inf-trans": (64, 17, 30, {}),
    "s220": (220, 17, 30, {}),
    "s220-ragged": (220, 301, 8, {}),
    "wide-trans": (300, 17, 30, {}),
    "s503-ragged": (503, 37, 20, {}),
    "s503-t1": (503, 5, 1, {}),
    "s1000": (1000, 5, 20, {}),
    "s58-short": (58, 40, 30, {"short": True}),
    "s58-zeros": (58, 9, 20, {"zeros": True}),
    "s1000-zeros": (1000, 3, 6, {"zeros": True}),
}


def _dense_random_case(dev, case):
    s, b, t, opts = DENSE_RANDOM[case]
    gen = torch.Generator(device=dev).manual_seed(s + b)

    def zeros(*shape):
        sign = torch.rand(shape, generator=gen, device=dev) < 0.5
        return torch.where(sign, -0.0, 0.0)

    if opts.get("zeros"):
        trans, alpha0, log_b = zeros(s, s), zeros(b, s), zeros(b, t, s)
    else:
        trans = torch.randn((s, s), generator=gen, device=dev)
        alpha0 = torch.randn((b, s), generator=gen, device=dev)
        alpha0[torch.rand((b, s), generator=gen, device=dev) < 0.3] = float("-inf")
        log_b = torch.randint(-3, 1, (b, t, s), generator=gen, device=dev).float()
    trans[torch.rand((s, s), generator=gen, device=dev) < 0.4] = float("-inf")
    trans[:, min(1, s - 1)] = float("-inf")
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    if opts.get("short"):
        lengths[::3] = 1
        lengths[1::7] = 0
    before = tdn.trellis_dense_forward.launches
    runs = kernel_runs(tdn.trellis_dense_forward, log_b, trans, alpha0, lengths)
    assert tdn.trellis_dense_forward.launches == before + 2  # one launch a poison
    want = plain_run(dense_forward, log_b, trans, alpha0, lengths)
    torch.cuda.synchronize()
    for got in runs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))


def test_dense_trellis_branch_by_states(dev):
    assert {s: tdn.trellis_dense_branch(s) for s in DENSE_BRANCH} == DENSE_BRANCH


@pytest.mark.parametrize("case", ["flagship", "503", "ties", "b5-t1", "padded",
                                  *DENSE_RANDOM])
def test_dense_trellis_is_bitwise_plain(dev, case):
    if case in DENSE_RANDOM:
        s = DENSE_RANDOM[case][0]
        assert tdn.trellis_dense_branch(s) == DENSE_BRANCH.get(
            s, "block" if s <= 240 else "cluster" if s <= 512 else "streamed")
        _dense_random_case(dev, case)
        return
    gen = torch.Generator(device=dev).manual_seed(4)
    comp = _composite(100) if case == "503" else flagship_composite()
    s = comp.num_states
    b, t = {"b5-t1": (5, 1), "503": (8, 40)}.get(case, (33, 50))
    if case == "ties":
        log_b = torch.randint(-3, 1, (b, t, s), generator=gen, device=dev).float()
    elif case == "padded":  # the emission kernel's 128-column layout
        log_b = 3 * torch.randn((b, t, 128), generator=gen, device=dev)
    else:
        log_b = 3 * torch.randn((b, t, s), generator=gen, device=dev)
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit, comp.penalty)
    before = (tdn.trellis_dense_forward.launches, tsf.trellis_backtrace.launches)
    runs = kernel_runs(tdn.viterbi_composite_batch_pallas, log_b, *topo, lengths)
    assert (tdn.trellis_dense_forward.launches, tsf.trellis_backtrace.launches) == (
        before[0] + 2, before[1] + 2)  # one of each a poison
    want = plain_run(viterbi_composite_batch, log_b[..., :s].contiguous(), *topo, lengths)
    torch.cuda.synchronize()
    for got in runs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_sentence_trellis_keeps_the_sign_of_zero(dev):
    """Every coefficient and emission a zero of random sign: candidates tie
    at zeros, and the sentence kernel must take the winner's value, not a
    max's."""
    gen = torch.Generator(device=dev).manual_seed(9)
    b, t, s = 12, 30, 59
    sign = lambda *sh: torch.rand(sh, generator=gen, device=dev) < 0.5  # noqa: E731
    zeros = lambda *sh: torch.where(sign(*sh), -0.0, 0.0)  # noqa: E731
    c0, c1, c2 = zeros(b, s), zeros(b, s), zeros(b, s)
    c1[:, :1] = float("-inf")
    c2[:, :2] = float("-inf")
    log_b = zeros(b, t, s)
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    n_states = torch.full((b,), s, dtype=torch.int32, device=dev)
    fwd_runs = kernel_runs(tb.banded_forward, log_b, c0, c1, c2, lengths)
    runs = kernel_runs(tb.viterbi_banded_batch_scanfree, log_b, c0, c1, c2, lengths, n_states)
    want_fwd = plain_run(banded_sentence_forward, log_b, c0, c1, c2, lengths)
    want = plain_run(_banded_trellis_batch, log_b, c0, c1, c2, lengths, n_states)
    torch.cuda.synchronize()
    for (alpha, bp), got in zip(fwd_runs, runs):
        for g, w in zip((alpha, bp, *got), (*want_fwd, *want)):
            assert torch.equal(g, w)
        assert torch.equal(torch.signbit(alpha), torch.signbit(want_fwd[0]))
        assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))


@pytest.mark.parametrize("wrapper", ["fast", "lanes"])
def test_k5_k6_wrappers_are_bitwise_forward_fast(dev, wrapper):
    fn = (tfast.viterbi_fast_forward_pallas if wrapper == "fast"
          else tlanes.viterbi_lanes_forward_pallas)
    comp = flagship_composite()
    gen = torch.Generator(device=dev).manual_seed(5)
    log_b = 3 * torch.randn((40, 60, comp.num_states), generator=gen, device=dev)
    lengths = torch.randint(1, 61, (40,), generator=gen, device=dev, dtype=torch.int32)
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    before = tsf.trellis_forward.launches
    runs = kernel_runs(fn, log_b, *topo, comp.penalty, lengths)
    assert tsf.trellis_forward.launches == before + 2  # one launch a poison
    want = plain_run(forward_fast, log_b, pack_coefs(*topo, device=dev), comp.penalty, lengths)
    torch.cuda.synchronize()
    for got in runs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    comp = flagship_composite()
    s = comp.num_states
    nhp, lin, const = em.pack_quad_params(comp.means, comp.covariances, 128, device=dev)
    nhp_hi, nhp_lo = em.split_hi_lo(nhp)
    frames = torch.zeros((16, 39), device=dev)
    with pytest.raises(TypeError):  # float32 nhp where bf16 is due
        em.emission_split(frames, nhp, nhp_lo, lin, const, s, 128, passes=3)
    with pytest.raises(ValueError):  # no nhp_lo at 3 passes
        em.emission_split(frames, nhp_hi, None, lin, const, s, 128, passes=3)
    with pytest.raises(ValueError):  # a wrong shape
        em.emission_split(frames[:, :20], nhp_hi, nhp_lo, lin, const, s, 128, passes=3)
    with pytest.raises(ValueError):  # operands on different devices
        em.emission_split(frames, nhp_hi.cpu(), nhp_lo, lin, const, s, 128, passes=3)
    folded = em.fold_quad_params(nhp, lin, const, "default", s)
    w = folded.weights[0]
    shifted = torch.empty(w.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(w.shape)
    with pytest.raises(ValueError):  # a folded operand not 16-byte aligned
        em.emission_split(frames, None, None, lin, const, s, 128, passes=1,
                          folded=folded._replace(weights=(shifted,)))
    with pytest.raises(ValueError):  # another tier's folded operand
        em.emission_split(frames, None, None, lin, const, s, 128, passes=3, folded=folded)
    with pytest.raises(ValueError):
        em.emission(frames, nhp, lin, const, s, 128, folded=folded)
    with pytest.raises(ValueError):  # folded for another state count
        em.emission(frames, nhp, lin, const, s - 1, 128,
                    folded=em.fold_quad_params(nhp, lin, const, "highest", s))
    nhp96, lin96, const96 = (t[..., :96].contiguous() for t in (nhp, lin, const))
    with pytest.raises(ValueError):  # s_pad not a multiple of the 64-state tile
        em.emission_split(frames, nhp96.bfloat16(), None, lin96, const96, s, 96, passes=1)
    trans = torch.zeros((s, s), device=dev)
    alpha0 = torch.zeros((2, s), device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    log_b = torch.zeros((2, 3, s), device=dev)
    with pytest.raises(TypeError):
        tdn.trellis_dense_forward(log_b.double(), trans, alpha0, lengths)
    with pytest.raises(ValueError):  # log_b narrower than S
        tdn.trellis_dense_forward(log_b[..., :40].contiguous(), trans, alpha0, lengths)
    with pytest.raises(ValueError):
        tdn.trellis_dense_forward(log_b, trans, alpha0[:1], lengths)
    with pytest.raises(ValueError):
        tdn.trellis_dense_forward(log_b, trans, alpha0, lengths.cpu())
    big = tdn.MAX_STATES + 1
    with pytest.raises(ValueError):
        tdn.trellis_dense_forward(torch.zeros((1, 2, big), device=dev),
                                  torch.zeros((big, big), device=dev),
                                  torch.zeros((1, big), device=dev), lengths[:1])
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    with pytest.raises(ValueError):  # S past the TPU kernels' limits
        tfast.viterbi_fast_forward_pallas(torch.zeros((2, 3, 65), device=dev), *topo,
                                          -1.0, lengths)
    with pytest.raises(ValueError):
        tlanes.viterbi_lanes_forward_pallas(torch.zeros((2, 3, 129), device=dev), *topo,
                                            -1.0, lengths)


def test_decoder_pallas_backend_matches_scan_on_card(dev):
    from cs304_tpu_torch.data.batching import make_signals
    from cs304_tpu_torch.models.decoder import ContinuousDecoder

    signals = list(make_signals(6, 1.5, seed=12))
    kw = dict(penalty=-100.0, emissions="quad", device="cuda")
    dec = ContinuousDecoder(flagship_models(), backend="pallas", **kw)
    before = (em.emission.launches, tdn.trellis_dense_forward.launches,
              tsf.trellis_backtrace.launches)
    got = dec.predict_signal_batch(signals)
    after = (em.emission.launches, tdn.trellis_dense_forward.launches,
             tsf.trellis_backtrace.launches)
    assert all(a > b for a, b in zip(after, before))
    assert got == ContinuousDecoder(flagship_models(), backend="scan",
                                    **kw).predict_signal_batch(signals)
    high = ContinuousDecoder(flagship_models(), emission_precision="high", **kw)
    launches = em.emission_split.launches
    assert len(high.predict_signal_batch(signals)) == len(signals)
    assert em.emission_split.launches > launches


# -- the serving pool's step (stream mode, K4 dense step) and K2-bt on the ring


def _stream_steps(rng, b, c, t_max, n_steps, compact):
    """Pool steps as (slot_ids, t, valid) rows: staggered starts, uneven
    chunks of 1..c frames, idle slots, slot 0 recycled halfway; compact rows
    are the fed slots padded to a power of two with slot b and valid 0,
    otherwise one row a slot (valid 0 when idle)."""
    clock = np.zeros(b, np.int64)
    start = rng.integers(0, 3, b)
    for step in range(n_steps):
        if step == n_steps // 2:
            clock[0] = 0
        fed = [s for s in range(b)
               if step >= start[s] and rng.random() < 0.7 and clock[s] < t_max]
        valid = np.zeros(b, np.int64)
        for s in fed:
            valid[s] = min(int(rng.integers(1, c + 1)), t_max - clock[s])
        if compact:
            r = max(2, 1 << max(len(fed) - 1, 0).bit_length())
            slot_ids = np.full(r, b, np.int32)
            t = np.zeros(r, np.int32)
            v = np.zeros(r, np.int32)
            slot_ids[: len(fed)] = fed
            t[: len(fed)] = clock[fed]
            v[: len(fed)] = valid[fed]
        else:
            slot_ids, t, v = (np.arange(b, dtype=np.int32), clock.astype(np.int32),
                              valid.astype(np.int32))
        yield slot_ids, t, v
        clock += valid


def _poison_rows(ring, slot_ids, t, valid, pattern):
    """Fill the ring rows a pool step writes (t .. t + valid - 1 of each fed
    slot, the rows past T_max landing on its last) with a poison."""
    b, t_max = ring.shape[:2]
    for slot, t0, v in zip(*(np.asarray(x).tolist() for x in (slot_ids, t, valid))):
        if v > 0 and slot < b:
            poison_(ring[slot, min(t0, t_max - 1): min(t0 + v, t_max)], pattern)


def _stream_step_runs(step, alpha, ring, slot_ids, t, valid):
    """step(alpha, ring) on a copy of the pool's state under each kernel
    poison, the ring rows it writes poisoned first: the two copies agree in
    every bit (a row the step leaves unwritten keeps its poison); returns
    the first."""
    outs = []
    for pattern in KERNEL_POISONS:
        a, r = alpha.clone(), ring.clone()
        _poison_rows(r, slot_ids, t, valid, pattern)
        with poisoned(pattern):
            step(a, r)
        outs.append((a, r))
    assert differing_cells(*outs) == 0
    return outs[0]


@pytest.mark.parametrize("num_words,ring,penalty,compact,ties,c,clamp", [
    (11, torch.int8, -100.0, True, False, 8, False),    # the flagship, K=2 one-warp teams
    (11, torch.int32, -100.0, False, True, 8, False),   # dense upload, integer ties
    (11, torch.int8, 0.0, True, True, 8, False),        # zero penalty: the butterfly fork
    (19, torch.int8, -100.0, False, False, 8, False),   # 98 states, K=4, one warp
    (100, torch.int32, -100.0, True, False, 8, False),  # 503 states, a 4-warp team
    (1000, torch.int32, 0.0, True, False, 8, False),    # 5003 states, K=8, 20 warps
    (11, torch.int8, -100.0, True, False, 32, True),    # the flagship, 32 frames, clamped
    (74, torch.int32, -100.0, True, False, 16, True),   # 373 states, 3 warps (the phone tiers)
    (74, torch.int32, 0.0, False, True, 32, False),     # 373 states, zero penalty, ties
    (410, torch.int32, -100.0, True, False, 16, True),  # 2053: the first K=8 width, 9 warps
    (410, torch.int8, -100.0, False, False, 32, False),  # K=8's int8 build (ids wrap as the cast)
    (1000, torch.int32, -100.0, False, True, 32, True),  # 5003 states, the value path, ties
    (1637, torch.int32, -100.0, True, False, 32, True),  # 8188: 32 warps, 32 frames in 2 launches
    (1637, torch.int32, 0.0, False, False, 16, False),  # 8188 states, zero penalty
])
def test_stream_mode_is_bitwise_plain(dev, num_words, ring, penalty, compact, ties, c, clamp):
    """The stream mode bitwise _advance_compact (alpha with its signs of
    zero, and the ring) over 10 pool steps of c frames: staggered starts,
    fresh rows, idle rows of valid 0, a recycled slot; with clamp, one more
    step whose rows pass T_max (their frames land on its last row) beside
    rows of valid 0."""
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.ops.streaming_batch import _advance_compact, _coeffs_of

    comp = _composite(num_words)
    s = comp.num_states
    b, t_max = 6, 40
    coefs = pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                       device=dev)
    alpha = torch.full((b, s), float("-inf"), device=dev)
    ring_d = torch.full((b, t_max, s), -1, dtype=ring, device=dev)
    alpha_p, ring_p = alpha.cpu(), ring_d.cpu()
    coefs_p = coefs.cpu()
    rng = np.random.default_rng(num_words)
    before = tst.stream_advance.launches
    steps = list(_stream_steps(rng, b, c, t_max, 10, compact))
    if clamp:
        ids = np.arange(b, dtype=np.int32)
        steps.append((ids, np.full(b, t_max - 3, np.int32),
                      np.where(ids % 3 == 2, 0, c).astype(np.int32)))
    for slot_ids, t, valid in steps:
        shape = (len(slot_ids), c, s)
        log_b = (rng.integers(-3, 1, shape) if ties else 3 * rng.normal(size=shape))
        log_b = torch.as_tensor(log_b.astype(np.float32))
        rows = [torch.as_tensor(x, device=dev) for x in (slot_ids, t, valid)]
        alpha, ring_d = _stream_step_runs(
            lambda a, r: tst.stream_advance(a, r, *rows, log_b.to(dev), coefs, penalty),
            alpha, ring_d, slot_ids, t, valid)
        _poison_rows(ring_p, slot_ids, t, valid, PLAIN_POISON)
        _advance_compact(alpha_p, ring_p, slot_ids, t, valid, log_b, coefs_p[6],
                         coefs_p[4] > 0, coeffs=_coeffs_of(coefs_p, penalty))
        torch.cuda.synchronize()
        assert torch.equal(alpha.cpu(), alpha_p)
        assert torch.equal(torch.signbit(alpha.cpu()), torch.signbit(alpha_p))
        assert torch.equal(ring_d.cpu(), ring_p)
    assert tst.stream_advance.launches == before + 2 * len(steps)  # one a poison


@pytest.mark.parametrize("compact", [False, True])
def test_dense_step_through_k4_matches_advance(dev, compact):
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.ops.streaming_batch import _advance_compact
    from cs304_tpu_torch.ops.viterbi import composite_transition_matrix

    comp = flagship_composite()
    s = comp.num_states
    b, c, t_max = 6, 8, 40
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    coefs = pack_coefs(*topo, device=dev)
    trans = composite_transition_matrix(*topo, comp.penalty, device=dev)
    alpha = torch.full((b, s), float("-inf"), device=dev)
    ring = torch.full((b, t_max, s), -1, dtype=torch.int8, device=dev)
    alpha_p, ring_p, coefs_p, trans_p = alpha.cpu(), ring.cpu(), coefs.cpu(), trans.cpu()
    rng = np.random.default_rng(3)
    before = tdn.trellis_dense_forward.launches
    for slot_ids, t, valid in _stream_steps(rng, b, c, t_max, 10, compact):
        log_b = torch.as_tensor(rng.integers(-3, 1, (len(slot_ids), c, s)).astype(np.float32))
        alpha, ring = _stream_step_runs(
            lambda a, r: tst.dense_stream_advance(a, r, slot_ids, t, valid, log_b.to(dev),
                                                  trans, coefs),
            alpha, ring, slot_ids, t, valid)
        _poison_rows(ring_p, slot_ids, t, valid, PLAIN_POISON)
        _advance_compact(alpha_p, ring_p, slot_ids, t, valid, log_b, coefs_p[6],
                         coefs_p[4] > 0, trans=trans_p)
        torch.cuda.synchronize()
        assert torch.equal(alpha.cpu(), alpha_p)
        assert torch.equal(ring.cpu(), ring_p)
    assert tdn.trellis_dense_forward.launches > before


@pytest.mark.parametrize("ring_dtype", [torch.int8, torch.int32])
def test_backtrace_walks_a_ring_slice_in_place(dev, ring_dtype):
    """K2-bt on ring[:, :T] of a (B, T_max, S) ring, int8 and int32, against
    backtrace_batch on a contiguous int32 copy; S = 58 makes an int8 row
    start at every byte alignment."""
    comp = flagship_composite()
    s = comp.num_states
    coefs = pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    b, t_max, t = 9, 700, 512
    lengths = torch.randint(0, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = t, 1
    log_b = 3 * torch.randn((b, t_max, s), generator=gen, device=dev)
    alpha, bp = forward_fast(log_b, coefs, comp.penalty, torch.full_like(lengths, t_max))
    ring = bp.to(ring_dtype)
    best = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
    view = ring[:, :t]
    assert not view.is_contiguous()
    runs = kernel_runs(tsf.trellis_backtrace, view, best, lengths, quirk=False)
    want = plain_run(backtrace_batch_plain, view.to(torch.int32).contiguous(), best, lengths)
    torch.cuda.synchronize()
    for got in runs:
        assert torch.equal(got, want)


def backtrace_batch_plain(bp, best, lengths):
    from cs304_tpu_torch.ops.viterbi import backtrace_batch

    return backtrace_batch(bp, best, lengths, quirk=False)


def test_serving_pool_defaults_to_the_card_and_raises_without_one(dev, monkeypatch):
    from cs304_tpu_torch.ops.streaming_batch import BatchedStreamingComposite
    from cs304_tpu_torch.serving import ServingSessionPool

    pool = ServingSessionPool(flagship_models(), num_slots=2, max_frames=64)
    assert pool._pool.device.type == "cuda" and pool._decoder.device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ServingSessionPool(flagship_models(), num_slots=2)
    with pytest.raises(RuntimeError):
        BatchedStreamingComposite(flagship_composite(), num_slots=2)


def test_streaming_composite_on_card_matches_cpu(dev):
    """The single-stream decoder's chunk step is K4 on the card; its partials
    and final path equal the CPU run's (emissions differ in the last bits,
    so the score is held within rel 1e-5)."""
    from cs304_tpu_torch.ops.streaming import StreamingComposite

    comp = flagship_composite()
    feats = (np.asarray(comp.means)[np.random.default_rng(5).integers(0, 58, 70)]
             + np.random.default_rng(6).normal(0, 0.3, (70, 39))).astype(np.float32)
    runs = {}
    before = tdn.trellis_dense_forward.launches
    for d in ("cuda", "cpu"):
        stream = StreamingComposite(comp, chunk_size=16, device=d)
        parts = []
        for lo in range(0, 70, 13):
            stream.feed(feats[lo: lo + 13])
            parts.append(stream.partial_labels())
        runs[d] = (parts, stream.finalize())
    assert tdn.trellis_dense_forward.launches > before
    assert runs["cuda"][0] == runs["cpu"][0]
    np.testing.assert_array_equal(runs["cuda"][1][1], runs["cpu"][1][1])
    assert runs["cuda"][1][0] == pytest.approx(runs["cpu"][1][0], rel=1e-5)


def _fb_case(dev, b, t, s, seed, zero_length=False, sprinkle=True):
    """A sentence forward-backward problem, drawn on the CPU from a seed and
    moved to the card: log_b, c0/c1/c2 with -inf off the band's start (and
    sprinkled when asked: in odd rows into log_b, c1 and c2 independently,
    which walls off states and, over long T, kills whole utterances; in
    even rows into c1 and c2, never both at one state), lengths, finals. The band advances at most two states a frame:
    each final lies in the top quarter of [0, reach], reach = min(S - 1,
    1.5 (length - 1)), row 0's at reach (S - 1 where T >= 2S / 3 + 1, so
    that every warp of a block team carries mass), and rows 3, 11, ... at
    2 (length - 1) + 1, past the band (ll = -inf), where that is a state."""
    gen = torch.Generator().manual_seed(seed)
    log_b = 2 * torch.randn((b, t, s), generator=gen)
    c0, c1, c2 = (0.5 * torch.randn((b, s), generator=gen) for _ in range(3))
    c1[:, :1] = float("-inf")
    c2[:, :2] = float("-inf")
    if sprinkle:
        hole = torch.rand((b, s), generator=gen) < 0.15
        c1[hole] = float("-inf")
        odd = (torch.arange(b) % 2 == 1)[:, None]
        c2[(torch.rand((b, s), generator=gen) < 0.15) & (odd | ~hole)] = float("-inf")
        log_b[(torch.rand((b, t, s), generator=gen) < 0.03) & odd[..., None]] = float("-inf")
    lengths = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32)
    lengths[0] = t
    if zero_length:
        lengths[1::3] = 0
        lengths[2::5] = 1
    reach = torch.clamp(3 * (lengths - 1) // 2, min=0, max=s - 1)
    drop = (torch.rand((b,), generator=gen) * (reach // 4 + 1).float()).floor()
    final = reach - drop.to(torch.int32)
    final[0] = reach[0]
    past = 2 * (lengths - 1) + 1
    off = torch.zeros((b,), dtype=torch.bool)
    off[3::8] = True
    final = torch.where(off & (lengths >= 1) & (past < s), past, final).to(torch.int32)
    return tuple(x.to(dev) for x in (log_b, c0, c1, c2, lengths, final))


def _fb_coverage(prob, gamma, xi, ll):
    """What an E-step case exercises, asserted before its comparison counts:
    at least half of the utterances of length >= 1 have a finite ll, row 0
    among them, and the highest state with nonzero gamma in row 0 is its
    final; for each such utterance every live gamma row sums to 1 and the
    xi sums to length - 1 over the three diagonals (a posterior's own
    identities) within 25%: a check of coverage, not of accuracy (that is
    the comparison), since float32 chains of 2T steps at |ll| ~ T drift by
    ~9% at T = 4000 (chip_smoke.py phase 19). Returns
    (share of finite ll, row 0's highest state with nonzero gamma)."""
    lengths, final = prob[4].long(), prob[5].long()
    live = lengths >= 1
    valid = torch.isfinite(ll) & live
    share = float(valid.sum()) / max(int(live.sum()), 1)
    assert share >= 0.5 and bool(valid[0]), (share, bool(valid[0]))
    t = gamma.shape[1]
    rows = torch.arange(t, device=gamma.device)[None, :] < lengths[:, None]
    sums = gamma.sum(dim=2)
    assert bool(((sums - 1).abs() <= 0.25)[rows & valid[:, None]].all())
    pairs = (lengths - 1).clamp(min=0).to(xi.dtype)
    assert bool(((xi.sum(dim=(1, 2)) - pairs).abs() <= 0.25 * pairs.clamp(min=1))[valid].all())
    top = int(torch.nonzero(gamma[0].amax(dim=0) > 0).max())
    assert top == int(final[0]), (top, int(final[0]))
    return share, top


FB_CASES = [(64, 160, 59, False), (40, 50, 59, True), (5, 1, 59, False), (8, 70, 98, True),
            (12, 90, 128, False), (4, 340, 503, False), (2, 1500, 2100, False),
            (3, 600, 33, True), (6, 12, 1, False)]


@pytest.mark.parametrize("case", FB_CASES)
def test_sentence_forward_backward_matches_plain(dev, case):
    """FB against banded_fb_plain on the card: every cell bitwise (IEEE
    expf / logf on both sides, each add of their results a __fadd_rn); one
    launch a call."""
    from cs304_tpu_torch.ops.cuda import trellis_fb as tfb

    b, t, s, zero = case
    prob = _fb_case(dev, b, t, s, seed=b * 7 + s, zero_length=zero)
    before = tfb.banded_fb.launches
    runs = kernel_runs(tfb.banded_fb, *prob)
    want = plain_run(tfb.banded_fb_plain, *prob)
    torch.cuda.synchronize()
    assert tfb.banded_fb.launches == before + 2  # one launch a poison
    for got in runs:
        for g, w, name in zip(got, want, ("alpha", "beta", "ll")):
            assert g.shape == w.shape, name
            assert not torch.isnan(g).any(), name
            assert _same_bits(g, w), (name, int((g.view(torch.int32)
                                                != w.view(torch.int32)).sum()))


@pytest.mark.parametrize("case", FB_CASES)
def test_fb_posteriors_match_plain(dev, case):
    """The E-step mode against banded_fb_posteriors_plain on FB's cases,
    which reach their finals (_fb_coverage): every cell bitwise, signs of
    zero too (IEEE expf / logf on both sides, in the same order, each add of
    their results a __fadd_rn); one launch a call, FB's alpha/beta mode not
    launched."""
    from cs304_tpu_torch.ops.cuda import trellis_fb as tfb

    b, t, s, zero = case
    prob = _fb_case(dev, b, t, s, seed=b * 7 + s, zero_length=zero)
    before, fb_before = tfb.banded_fb_posteriors.launches, tfb.banded_fb.launches
    runs = kernel_runs(tfb.banded_fb_posteriors, *prob)
    want = plain_run(tfb.banded_fb_posteriors_plain, *prob)
    torch.cuda.synchronize()
    assert tfb.banded_fb_posteriors.launches == before + 2  # one launch a poison
    assert tfb.banded_fb.launches == fb_before
    for got in runs:
        _fb_coverage(prob, *got)
        for g, w, name in zip(got, want, ("gamma", "xi", "ll")):
            assert g.shape == w.shape, name
            assert not torch.isnan(g).any(), name
            assert _same_bits(g, w), (name, int((g.view(torch.int32)
                                                != w.view(torch.int32)).sum()))


def test_bw_iteration_launches_fb_and_matches_plain_fb(dev):
    """One fused Baum-Welch iteration on the card launches the E-step mode of
    FB once and its alpha/beta mode never, and gives the plain E-step's
    parameters (rtol 1e-4 / atol 1e-5)."""
    from cs304_tpu_torch.models import train_fused as tf
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainer, insert_silence
    from cs304_tpu_torch.ops.cuda import trellis_fb as tfb

    models = {m.label: m for m in flagship_models(seed=0)}
    rng = np.random.default_rng(1)
    labeled = {}
    for tr in ("14", "27Z"):
        feats = []
        for _ in range(6):
            frames = [models[w].means[i] + rng.normal(0, 0.7, size=(3, 39))
                      for w in insert_silence(tr) for i in range(models[w].num_states)]
            feats.append(np.concatenate(frames).astype(np.float32))
        labeled[tr] = feats
    trainer = ContinuousTrainer(models, device=dev)
    corpus = tf.prepare_fused_corpus(labeled, trainer.state_counts, trainer.label_index,
                                     insert_silence, 32, device=dev)
    args, kwargs = trainer._fused_args(corpus), trainer._fused_kwargs()
    before, fb_before = tfb.banded_fb_posteriors.launches, tfb.banded_fb.launches
    runs = kernel_runs(tf.fused_bw_iteration, *args, **kwargs)
    assert tfb.banded_fb_posteriors.launches == before + 2  # one launch a poison
    assert tfb.banded_fb.launches == fb_before
    tf._FB_BACKEND = "plain"
    try:
        want = plain_run(tf.fused_bw_iteration, *args, **kwargs)
    finally:
        tf._FB_BACKEND = "kernel"
    torch.cuda.synchronize()
    for got in runs:
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(torch.isfinite(g), torch.isfinite(w))
            fin = torch.isfinite(w)
            torch.testing.assert_close(g[fin], w[fin], rtol=1e-4, atol=1e-5)


def test_fb_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from cs304_tpu_torch.ops.cuda import trellis_fb as tfb

    prob = _fb_case(dev, 2, 4, tfb.MAX_FB_STATES + 1, seed=1, sprinkle=False)
    with pytest.raises(ValueError, match="states"):
        tfb.banded_fb(*prob)
    log_b, c0, c1, c2, lengths, final = _fb_case(dev, 2, 4, 9, seed=2)
    with pytest.raises(TypeError):
        tfb.banded_fb(log_b, c0, c1, c2, lengths.long(), final)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.banded_fb(log_b.transpose(1, 2).contiguous().transpose(1, 2), c0, c1, c2,
                      lengths, final)
    with pytest.raises(ValueError):
        tfb.banded_fb(log_b, c0[:1], c1, c2, lengths, final)


def test_fb_posteriors_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from cs304_tpu_torch.ops.cuda import trellis_fb as tfb

    prob = _fb_case(dev, 2, 4, tfb.MAX_FB_STATES + 1, seed=1, sprinkle=False)
    with pytest.raises(ValueError, match="states"):
        tfb.banded_fb_posteriors(*prob)
    log_b, c0, c1, c2, lengths, final = _fb_case(dev, 2, 4, 9, seed=2)
    with pytest.raises(TypeError):
        tfb.banded_fb_posteriors(log_b, c0, c1, c2, lengths, final.long())
    with pytest.raises(ValueError, match="contiguous"):
        tfb.banded_fb_posteriors(log_b, c0.t().contiguous().t(), c1, c2, lengths, final)
    with pytest.raises(ValueError):
        tfb.banded_fb_posteriors(log_b, c0, c1, c2[:1], lengths, final)
    with pytest.raises(ValueError):
        tfb.banded_fb_posteriors(log_b, c0, c1, c2, lengths.cpu(), final)


# -- the search modes: LM decode, BEAM decode, LM stream ----------------------


def _search_pair(comp, mode):
    """(W, W) pair penalties of a bigram trained on random word strings
    (word_pair_penalties, lm_weight 1); "ties" sets every pair equal, "zero"
    sets some pair values to exactly 0."""
    from cs304_tpu_torch.ops.lm import train_word_bigram, word_pair_penalties

    rng = np.random.default_rng(len(comp.labels))
    words = [lab for lab in comp.labels if lab != "S"]
    corpus = [tuple(rng.choice(words, size=int(rng.integers(1, 8)))) for _ in range(200)]
    pair = word_pair_penalties(comp, train_word_bigram(corpus, comp.labels), 1.0)
    if mode == "ties":
        pair[:] = np.float32(-7.0)
    elif mode == "zero":
        pair[:, :2] = 0.0
        pair[1] = 0.0
    return pair


# name: (num_words, None for the flagship or a tuple of word state counts;
# B, T, pair mode or None ("int": integer log_b, no LM), beam[, penalty]).
# "lm-5003" and "beam-5003-t60" keep their codes (and the LM's W int16
# sources a step) in the global scratch. "beam-0": 40 one-state words
# (every state an exit), integer ties, only the step's max kept;
# "beam-exits-cut": every exit at -30 at frame 5, so the beam prunes every
# exit there and step 6 takes the (-inf, 0) exit.
GLOBAL_SEARCH = {"lm-5003", "beam-5003-t60"}
SEARCH_CASES = {
    "lm-flagship": (None, 33, 60, "trained", None),
    "lm-ties": (None, 16, 40, "ties", None),
    "lm-zero": (None, 16, 40, "zero", None),
    "lm-98": (19, 9, 50, "trained", None),
    "lm-503": (100, 8, 60, "trained", None),
    "lm-5003": (1000, 2, 30, "trained", None),
    "beam-50": (None, 33, 60, None, 50.0),
    "beam-tight": (None, 33, 60, None, 6.0),
    "beam-503": (100, 8, 60, None, 10.0),
    "lm-beam": (None, 33, 60, "trained", 20.0),
    "lm-beam-503": (100, 8, 40, "trained", 10.0),
    "beam-2053": (410, 4, 40, None, 10.0),
    "beam-5003": (1000, 2, 30, None, 10.0),
    "beam-5003-t60": (1000, 2, 60, None, 10.0),
    "beam-0": ((1,) * 40, 16, 40, "int", 0.0),
    "beam-zero-penalty": (None, 33, 60, None, 8.0, 0.0),
    "beam-503-zero-penalty": (100, 8, 60, None, 10.0, 0.0),
    "beam-exits-cut": (None, 33, 60, None, 10.0),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_decode_modes_are_bitwise_plain(dev, case):
    from cs304_tpu_torch.ops.viterbi import lm_tables

    words, b, t, mode, beam, *penalty = SEARCH_CASES[case]
    if words is None:
        comp = flagship_composite()
    elif isinstance(words, tuple):
        comp = _word_topology(words, len(words))
    else:
        comp = _composite(words)
    penalty = penalty[0] if penalty else comp.penalty
    s = comp.num_states
    gen = torch.Generator(device=dev).manual_seed(4)
    if mode in ("ties", "int"):
        log_b = torch.randint(-3, 1, (b, t, s), generator=gen, device=dev).float()
    else:
        log_b = 3 * torch.randn((b, t, s), generator=gen, device=dev)
    if case == "beam-exits-cut":
        log_b[:, 5, torch.as_tensor(comp.uppers, device=dev).long()] = -30.0
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 1, t
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    coefs = pack_coefs(*topo, device=dev)
    pair = _search_pair(comp, mode) if mode in ("trained", "ties", "zero") else None
    n_words = len(comp.labels) if pair is not None else 0
    assert (tsf.codes_scratch_bytes(b, t, s, n_words) > 0) == (case in GLOBAL_SEARCH)
    counter = tsf.scanfree_decode_lm if pair is not None else tsf.scanfree_decode_beam
    before = counter.launches
    if pair is not None:
        lm = lm_tables(pair, comp.word_of_state, comp.uppers, device=dev)
        runs = kernel_runs(tsf.scanfree_decode_lm, log_b, coefs, lm, lengths, beam=beam)
    else:
        runs = kernel_runs(tsf.scanfree_decode_beam, log_b, coefs, penalty, lengths, beam)
    want = plain_run(
        viterbi_composite_batch_fast, log_b, *topo, penalty, lengths, pair_penalty=pair,
        word_of_state=comp.word_of_state, uppers=comp.uppers, beam=beam)
    torch.cuda.synchronize()
    assert counter.launches == before + 2  # one launch a poison
    for got in runs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))
    # No case compares -inf alone.
    assert torch.isfinite(want[0]).float().mean().item() >= 0.5


@pytest.mark.parametrize("num_words,ring,compact,mode", [
    (11, torch.int8, True, "trained"),     # the flagship, one-warp teams
    (11, torch.int8, False, "ties"),       # dense rows, equal pairs, integer ties
    (11, torch.int32, True, "zero"),       # zero pair values
    (100, torch.int32, True, "trained"),   # 503 states, a 4-warp team
    (1000, torch.int32, False, "trained"),  # 5003 states, 20 warps, W = 1001
])
def test_stream_lm_mode_is_bitwise_plain(dev, num_words, ring, compact, mode):
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.ops.streaming_batch import _advance_compact, _coeffs_of
    from cs304_tpu_torch.ops.viterbi import lm_tables

    comp = flagship_composite() if num_words == 11 else _composite(num_words)
    s = comp.num_states
    b, c, t_max = 6, 8, 40
    coefs = pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                       device=dev)
    pair = _search_pair(comp, mode)
    lm = lm_tables(pair, comp.word_of_state, comp.uppers, device=dev)
    lm_p = tuple(x.cpu() for x in lm)
    alpha = torch.full((b, s), float("-inf"), device=dev)
    ring_d = torch.full((b, t_max, s), -1, dtype=ring, device=dev)
    alpha_p, ring_p, coefs_p = alpha.cpu(), ring_d.cpu(), coefs.cpu()
    rng = np.random.default_rng(num_words + 7)
    before, before_flat = tst.stream_advance_lm.launches, tst.stream_advance.launches
    for slot_ids, t, valid in _stream_steps(rng, b, c, t_max, 10, compact):
        shape = (len(slot_ids), c, s)
        log_b = (rng.integers(-3, 1, shape) if mode == "ties" else 3 * rng.normal(size=shape))
        log_b = torch.as_tensor(log_b.astype(np.float32))
        rows = [torch.as_tensor(x, device=dev) for x in (slot_ids, t, valid)]
        alpha, ring_d = _stream_step_runs(
            lambda a, r: tst.stream_advance_lm(a, r, *rows, log_b.to(dev), coefs, lm),
            alpha, ring_d, slot_ids, t, valid)
        _poison_rows(ring_p, slot_ids, t, valid, PLAIN_POISON)
        _advance_compact(alpha_p, ring_p, slot_ids, t, valid, log_b, coefs_p[6],
                         coefs_p[4] > 0, coeffs=_coeffs_of(coefs_p, comp.penalty, lm_p))
        torch.cuda.synchronize()
        assert torch.equal(alpha.cpu(), alpha_p)
        assert torch.equal(torch.signbit(alpha.cpu()), torch.signbit(alpha_p))
        assert torch.equal(ring_d.cpu(), ring_p)
    assert torch.isfinite(alpha_p).any(dim=1).float().mean().item() >= 0.5
    assert tst.stream_advance_lm.launches == before + 2 * 10  # one a poison
    assert tst.stream_advance.launches == before_flat


# -- the LM entry update: W at a warp's edges, W off the four-source groups,
# steps whose every exit is -inf, signed-zero ties across source words, and
# each side of the pair table's shared / global branch --------------------


def _word_topology(counts, seed):
    """A composite of left-to-right words with the given state counts and
    random self / next / skip log transitions (no Gaussians)."""
    from cs304_tpu_torch.models.hmm import CompositeHMM

    rng = np.random.default_rng(seed)
    s = sum(counts)
    log_a = np.full((s, s), -np.inf, np.float32)
    base = 0
    for n in counts:
        for i in range(n):
            for d in range(min(3, n - i)):
                log_a[base + i, base + i + d] = np.log(rng.uniform(0.1, 1.0))
        base += n
    return CompositeHMM(labels=[f"w{i}" for i in range(len(counts))], state_counts=list(counts),
                        means=np.zeros((s, 1), np.float32),
                        covariances=np.ones((s, 1, 1), np.float32), log_a=log_a)


def _signed(rng, shape, p_inf, p_neg):
    """-inf with probability p_inf, else -0 with probability p_neg, else +0."""
    zeros = np.where(rng.random(shape) < p_neg, np.float32(-0.0), np.float32(0.0))
    return np.where(rng.random(shape) < p_inf, np.float32(-np.inf), zeros).astype(np.float32)


def _lm_problem(dev, case, rng):
    """(coefs (8, S), lm tables, emissions(rows, t) -> (rows, t, S) float32
    numpy) of an LM case. "zeros-W": W one-state words whose states are
    entry and exit with no self-loop, signed-zero t = 0 weights, emissions
    and pair values (mostly -0, some -inf), so every step's candidates tie
    at +-0 across source words. Otherwise LM_SPLIT_CASES' (state counts, pair,
    emissions): pair "trained" is _search_pair's, "rand" normal with 10%
    -inf; emissions "exits-inf" put -inf on every exit state at frame 5
    (every candidate of step 6 is -inf)."""
    from cs304_tpu_torch.ops.viterbi import lm_tables

    if case.startswith("zeros-"):
        w = int(case.split("-")[1])
        neg = np.full(w, -np.inf, np.float32)
        ones = np.ones(w, np.float32)
        coefs = np.stack([neg, neg, neg, neg, ones, ones, _signed(rng, w, 0.0, 0.7),
                          np.zeros(w, np.float32)])
        lm = lm_tables(_signed(rng, (w, w), 0.3, 0.6), np.arange(w), np.arange(w), device=dev)
        return (torch.as_tensor(coefs, device=dev), lm,
                lambda rows, t: _signed(rng, (rows, t, w), 0.15, 0.8))
    counts, pair_kind, emissions = LM_SPLIT_CASES[case]
    comp = flagship_composite() if counts is None else _word_topology(counts, len(counts))
    s, w = comp.num_states, len(comp.labels)
    coefs = pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit, device=dev)
    if pair_kind == "trained":
        pair = _search_pair(comp, "trained")
    else:
        pair = (3 * rng.normal(size=(w, w)) - 2).astype(np.float32)
        pair[rng.random((w, w)) < 0.1] = -np.inf

    def emit(rows, t):
        log_b = (3 * rng.normal(size=(rows, t, s))).astype(np.float32)
        if emissions == "exits-inf" and t > 5:
            log_b[:, 5, comp.uppers] = -np.inf
        return log_b

    return coefs, lm_tables(pair, comp.word_of_state, comp.uppers, device=dev), emit


# case: (state counts or None for the flagship, pair, emissions). W = 1; W =
# 31 / 32 / 33 two-state words (one-warp teams, one word a lane, lane 0
# taking words 0 and 32 at 33); 30 five-state words + silence (W = 31 on a
# two-warp team); 12 + silence (W = 13, off the four-source groups); every
# exit -inf at frame 5 on the flagship and at 503 states; 200 words at T =
# 27 / 28, either side of the decode table's shared / global branch with
# the codes in shared memory, and 199 (off the groups) on its global side;
# 222 words on the stream mode, which reads the table through the cache
# past 32 words; the flagship and 503 states on random emissions; 40
# one-state words (a one-warp team reading global columns in the stream mode).
LM_SPLIT_CASES = {
    "w1": ([3], "rand", "randn"),
    "w31": ([2] * 31, "rand", "randn"),
    "w32": ([2] * 32, "rand", "randn"),
    "w33": ([2] * 33, "rand", "randn"),
    "w31-two-warps": ([5] * 30 + [3], "rand", "randn"),
    "w13": ([5] * 12 + [3], "trained", "randn"),
    "flagship-exits-inf": (None, "trained", "exits-inf"),
    "503-exits-inf": ([5] * 100 + [3], "rand", "exits-inf"),
    "w200": ([5] * 199 + [3], "rand", "randn"),
    "w199": ([5] * 198 + [3], "rand", "randn"),
    "w40": ([1] * 40, "rand", "randn"),
    "w222": ([5] * 221 + [3], "rand", "randn"),
    "flagship": (None, "trained", "randn"),
    "503": ([5] * 100 + [3], "rand", "randn"),
}

# name: (case, B, T, beam, the table's branch).
LM_DECODE_SPLIT = {
    "w1": ("w1", 9, 40, None, "registers"),
    "w31": ("w31", 9, 40, None, "registers"),
    "w32": ("w32", 9, 40, None, "registers"),
    "w33": ("w33", 9, 40, 15.0, "shared"),
    "w31-two-warps": ("w31-two-warps", 6, 40, None, "shared"),
    "w13": ("w13", 9, 40, None, "registers"),
    "flagship-exits-inf": ("flagship-exits-inf", 9, 40, None, "registers"),
    "503-exits-inf": ("503-exits-inf", 4, 30, None, "shared"),
    "zeros-12": ("zeros-12", 64, 8, None, "registers"),
    "zeros-40": ("zeros-40", 64, 8, None, "shared"),
    "w200-t27": ("w200", 3, 27, None, "shared"),
    "w200-t28": ("w200", 3, 28, None, "global"),
}


@pytest.mark.parametrize("name", sorted(LM_DECODE_SPLIT))
def test_lm_decode_split_is_bitwise_plain(dev, name):
    case, b, t, beam, branch = LM_DECODE_SPLIT[name]
    rng = np.random.default_rng(sorted(LM_DECODE_SPLIT).index(name))
    coefs, lm, emit = _lm_problem(dev, case, rng)
    s, w = coefs.shape[1], lm[0].shape[0]
    assert tsf.lm_table_branch(t, s, w) == branch
    assert tsf.codes_scratch_bytes(b, t, s, w) == 0
    log_b = torch.as_tensor(emit(b, t), device=dev)
    lengths = torch.as_tensor(rng.integers(1, t + 1, b), dtype=torch.int32, device=dev)
    lengths[0], lengths[1] = 1, t
    before = tsf.scanfree_decode_lm.launches
    runs = kernel_runs(tsf.scanfree_decode_lm, log_b, coefs, lm, lengths, beam=beam)
    assert tsf.scanfree_decode_lm.launches == before + 2  # one launch a poison
    want = plain_run(tsf._plain_search, log_b.cpu(), coefs.cpu(), 0.0, lengths.cpu(), True,
                     lm=tuple(x.cpu() for x in lm), beam=beam)
    for got in ([x.cpu() for x in run] for run in runs):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))
    assert torch.isfinite(want[0]).float().mean().item() >= 0.5


# name: (case, ring dtype, compact upload, the table's branch).
LM_STREAM_SPLIT = {
    "w1": ("w1", torch.int8, True, "registers"),
    "w31": ("w31", torch.int8, False, "registers"),
    "w32": ("w32", torch.int8, True, "registers"),
    "w33": ("w33", torch.int32, True, "global"),
    "w31-two-warps": ("w31-two-warps", torch.int32, False, "global"),
    "w13": ("w13", torch.int8, True, "registers"),
    "flagship-exits-inf": ("flagship-exits-inf", torch.int8, True, "registers"),
    "zeros-12": ("zeros-12", torch.int8, True, "registers"),
    "zeros-40": ("zeros-40", torch.int8, False, "global"),
    "w222": ("w222", torch.int32, True, "global"),
}


@pytest.mark.parametrize("name", sorted(LM_STREAM_SPLIT))
def test_lm_stream_split_is_bitwise_plain(dev, name):
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.ops.streaming_batch import _advance_compact, _coeffs_of

    case, ring, compact, branch = LM_STREAM_SPLIT[name]
    rng = np.random.default_rng(sorted(LM_STREAM_SPLIT).index(name) + 50)
    b, c, t_max = 6, 8, 40
    coefs, lm, emit = _lm_problem(dev, case, rng)
    s, w = coefs.shape[1], lm[0].shape[0]
    assert tsf.lm_table_branch(c, s, w, decode=False) == branch
    lm_p, coefs_p = tuple(x.cpu() for x in lm), coefs.cpu()
    alpha = torch.full((b, s), float("-inf"), device=dev)
    ring_d = torch.full((b, t_max, s), -1, dtype=ring, device=dev)
    alpha_p, ring_p = alpha.cpu(), ring_d.cpu()
    before = tst.stream_advance_lm.launches
    for slot_ids, t, valid in _stream_steps(rng, b, c, t_max, 10, compact):
        log_b = torch.as_tensor(emit(len(slot_ids), c))
        rows = [torch.as_tensor(x, device=dev) for x in (slot_ids, t, valid)]
        alpha, ring_d = _stream_step_runs(
            lambda a, r: tst.stream_advance_lm(a, r, *rows, log_b.to(dev), coefs, lm),
            alpha, ring_d, slot_ids, t, valid)
        _poison_rows(ring_p, slot_ids, t, valid, PLAIN_POISON)
        _advance_compact(alpha_p, ring_p, slot_ids, t, valid, log_b, coefs_p[6],
                         coefs_p[4] > 0, coeffs=_coeffs_of(coefs_p, 0.0, lm_p))
        torch.cuda.synchronize()
        assert torch.equal(alpha.cpu(), alpha_p)
        assert torch.equal(torch.signbit(alpha.cpu()), torch.signbit(alpha_p))
        assert torch.equal(ring_d.cpu(), ring_p)
    assert torch.isfinite(alpha_p).any(dim=1).float().mean().item() >= 0.5
    assert tst.stream_advance_lm.launches == before + 2 * 10  # one a poison



# name: (case, B, T, the table's branch): a NaN frame (every exit value NaN
# at frame 5, so every candidate of step 6) in the first half of the rows;
# W = 12 (no pad), 13 (pads in the register scan), 101 (the shared table)
# and 199 (global columns, a tail group).
LM_NAN_DECODE = {
    "flagship": ("flagship", 8, 30, "registers"),
    "w13": ("w13", 8, 30, "registers"),
    "503": ("503", 4, 30, "shared"),
    "w199-t29": ("w199", 4, 29, "global"),
}


@pytest.mark.parametrize("name", sorted(LM_NAN_DECODE))
def test_lm_decode_nan_frame_keeps_sources_in_range(dev, name):
    """A NaN frame leaves no candidate equal to the max: the kernel must
    still name source word 0 (no read past uppers), finish without a fault
    and walk only real states; the rows without NaN stay bitwise their
    plain version."""
    case, b, t, branch = LM_NAN_DECODE[name]
    rng = np.random.default_rng(sorted(LM_NAN_DECODE).index(name) + 90)
    coefs, lm, emit = _lm_problem(dev, case, rng)
    s, w = coefs.shape[1], lm[0].shape[0]
    assert tsf.lm_table_branch(t, s, w) == branch
    log_b = emit(b, t)
    log_b[: b // 2, 5] = np.nan
    log_b = torch.as_tensor(log_b, device=dev)
    lengths = torch.full((b,), t, dtype=torch.int32, device=dev)
    lengths[-1] = t // 2
    runs = kernel_runs(tsf.scanfree_decode_lm, log_b, coefs, lm, lengths)
    torch.cuda.synchronize()
    want = plain_run(tsf._plain_search, log_b[b // 2:].cpu(), coefs.cpu(), 0.0,
                     lengths[b // 2:].cpu(), True, lm=tuple(x.cpu() for x in lm))
    for scores, paths in runs:
        paths = paths.cpu()
        assert bool(((paths[: b // 2] >= 0) & (paths[: b // 2] < s)).all())
        got = scores[b // 2:].cpu()
        assert torch.equal(got, want[0]) and torch.equal(paths[b // 2:], want[1])
        assert torch.equal(torch.signbit(got), torch.signbit(want[0]))
    assert torch.isfinite(want[0]).float().mean().item() >= 0.5


# name: (case, ring dtype, the table's branch): the stream mode with a NaN
# last frame in every chunk from the third step on, in the slots of the
# first half (so the next chunk's first step scans NaN exits).
LM_NAN_STREAM = {
    "flagship": ("flagship", torch.int8, "registers"),
    "w13": ("w13", torch.int8, "registers"),
    "w33": ("w33", torch.int32, "global"),
    "w40": ("w40", torch.int8, "global"),
}


@pytest.mark.parametrize("name", sorted(LM_NAN_STREAM))
def test_lm_stream_nan_frame_keeps_sources_in_range(dev, name):
    """As the decode case: every ring row of a NaN slot names a real state
    (or is untouched), the other slots' alpha and ring rows stay bitwise the
    plain step's."""
    from cs304_tpu_torch.ops.cuda import trellis_stream as tst
    from cs304_tpu_torch.ops.streaming_batch import _advance_compact, _coeffs_of

    case, ring, branch = LM_NAN_STREAM[name]
    rng = np.random.default_rng(sorted(LM_NAN_STREAM).index(name) + 95)
    b, c, t_max = 6, 8, 40
    coefs, lm, emit = _lm_problem(dev, case, rng)
    s, w = coefs.shape[1], lm[0].shape[0]
    assert tsf.lm_table_branch(c, s, w, decode=False) == branch
    lm_p, coefs_p = tuple(x.cpu() for x in lm), coefs.cpu()
    alpha = torch.full((b, s), float("-inf"), device=dev)
    ring_d = torch.full((b, t_max, s), -1, dtype=ring, device=dev)
    alpha_p, ring_p = alpha.cpu(), ring_d.cpu()
    nan_slots, saw_nan = b // 2, False
    for step, (slot_ids, t, valid) in enumerate(_stream_steps(rng, b, c, t_max, 8, False)):
        log_b = emit(len(slot_ids), c)
        for i in np.flatnonzero((slot_ids < nan_slots) & (valid > 0)):
            if step >= 2:
                log_b[i, valid[i] - 1] = np.nan
        log_b = torch.as_tensor(log_b)
        rows = [torch.as_tensor(x, device=dev) for x in (slot_ids, t, valid)]
        alpha, ring_d = _stream_step_runs(
            lambda a, r: tst.stream_advance_lm(a, r, *rows, log_b.to(dev), coefs, lm),
            alpha, ring_d, slot_ids, t, valid)
        _poison_rows(ring_p, slot_ids, t, valid, PLAIN_POISON)
        _advance_compact(alpha_p, ring_p, slot_ids, t, valid, log_b, coefs_p[6],
                         coefs_p[4] > 0, coeffs=_coeffs_of(coefs_p, 0.0, lm_p))
        torch.cuda.synchronize()
        got_a, got_r = alpha.cpu(), ring_d.cpu()
        assert bool(((got_r[:nan_slots] >= -1) & (got_r[:nan_slots] < s)).all())
        assert torch.equal(got_a[nan_slots:], alpha_p[nan_slots:])
        assert torch.equal(torch.signbit(got_a[nan_slots:]), torch.signbit(alpha_p[nan_slots:]))
        assert torch.equal(got_r[nan_slots:], ring_p[nan_slots:])
        saw_nan |= bool(torch.isnan(got_a[:nan_slots]).any())
    assert saw_nan
    assert torch.isfinite(alpha_p[nan_slots:]).any(dim=1).float().mean().item() >= 0.5

def test_search_decoders_launch_their_modes_not_the_plain_trellis(dev, monkeypatch):
    from cs304_tpu_torch.data.batching import make_signals
    from cs304_tpu_torch.models import decoder as dm
    from cs304_tpu_torch.ops.lm import train_word_bigram

    signals = list(make_signals(8, 1.5, seed=12))
    rng = np.random.default_rng(5)
    digits = [lab for lab in flagship_composite().labels if lab != "S"]
    bigram = train_word_bigram(
        ["".join(rng.choice(digits, size=int(rng.integers(1, 8)))) for _ in range(300)],
        flagship_composite().labels)
    cases = (({"bigram": bigram, "lm_weight": 2.0}, tsf.scanfree_decode_lm),
             ({"beam": 50.0}, tsf.scanfree_decode_beam),
             ({"bigram": bigram, "beam": 80.0}, tsf.scanfree_decode_lm))
    want = [dm.ContinuousDecoder(flagship_models(), device="cpu", **kw)
            .predict_signal_batch(signals) for kw, _c in cases]

    def plain_on_card(*args, **kwargs):
        raise AssertionError("the plain trellis ran on the card")

    monkeypatch.setattr(dm, "viterbi_composite_batch_fast", plain_on_card)
    monkeypatch.setattr(tsf, "_plain_search", plain_on_card)
    for (kw, counter), texts in zip(cases, want):
        dec = dm.ContinuousDecoder(flagship_models(), device="cuda", **kw)
        assert dec.backend == "scanfree"
        before = counter.launches
        assert dec.predict_signal_batch(signals) == texts
        assert counter.launches > before


# The banded word trellis (ops/viterbi.viterbi_banded_batch) on K3: case ->
# (rows B, T, S, per-row log_a, length-0 rows). "kmeans" is the segmental
# k-means boot's shape (12 models x 64 utterances at 5 states, one log_a a
# model); "59-t1" the sentence width at T = 1.
WORD_TRELLIS = {
    "kmeans": (12 * 64, 96, 5, True, False),
    "59-t1": (17, 1, 59, False, True),
    "59-zero-length": (33, 60, 59, False, True),
    "s1": (9, 20, 1, True, False),
    "s2": (9, 20, 2, True, True),
    "s3-inf": (40, 30, 3, True, False),
}


def word_trellis_problem(gen, b, t, s, per_row, zero_length):
    """log_b (B, T, S), a left-to-right log_a ((B, S, S) or (S, S)) with
    -inf sprinkled on its band, lengths with short and (optionally)
    length-0 rows."""
    dev = gen.device
    shape = (b, s, s) if per_row else (s, s)
    log_a = torch.log(torch.rand(shape, generator=gen, device=dev))
    log_a[torch.rand(shape, generator=gen, device=dev) < 0.05] = float("-inf")
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[1] = min(2, t)  # too short to reach state S-1 for S > 5
    if zero_length:
        lengths[2::5] = 0
    return 2 * torch.randn((b, t, s), generator=gen, device=dev), log_a, lengths


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("case", sorted(WORD_TRELLIS))
def test_word_trellis_runs_k3_bitwise_plain(dev, case, quirk, monkeypatch):
    """viterbi_banded_batch on a CUDA tensor: one K3 decode launch with the
    quirk, the backpointer mode and K2-bt without it, never dense_forward;
    scores bitwise the plain version on every row, paths on every row with
    a finite score (ROADMAP W3)."""
    from cs304_tpu_torch.ops import viterbi as vt

    gen = torch.Generator(device=dev).manual_seed(7)
    log_b, log_a, lengths = word_trellis_problem(gen, *WORD_TRELLIS[case])
    want_s, want_p = plain_run(vt.viterbi_banded_batch_plain, log_b, log_a, lengths, quirk)
    counters = (tb.banded_decode, tb.banded_forward, tsf.trellis_backtrace)
    before = [c.launches for c in counters]

    def no_dense(*_a, **_k):
        raise AssertionError("dense_forward ran on a CUDA tensor")

    monkeypatch.setattr(vt, "dense_forward", no_dense)
    runs = kernel_runs(vt.viterbi_banded_batch, log_b, log_a, lengths, quirk)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == (
        [2, 0, 0] if quirk else [0, 2, 2])  # one launch a poison
    finite = torch.isfinite(want_s)
    b, t, s = log_b.shape
    if t >= (s + 1) // 2:  # the band reaches state S-1 in (S + 1) // 2 frames
        assert int(finite.sum()) >= b // 3
    for got_s, got_p in runs:
        assert torch.equal(got_s, want_s)
        assert torch.equal(got_p[finite], want_p[finite])


def dtw_problem(gen, word_lengths, n_frames, d=39, kind="random"):
    """Templates of the given word lengths on the generator's device -> (their
    DTWRecognizer, dist_t (L, H) of one sample against them). kind "random":
    random templates and a random sample of n_frames; "self": integer-valued
    templates and word 2's own frames as the sample (n_frames unused), so
    its distances are exactly 0 along its path and the prune threshold is a
    zero; "negative": dist_t drawn directly, normal with a tenth each of
    -0.0 and +0.0 (negative costs, signed zeros)."""
    from cs304_tpu_torch.ops.dtw import DTWRecognizer, pairwise_euclidean

    dev = gen.device
    if kind == "self":
        tmpl = [torch.randint(-3, 4, (n, d), generator=gen, device=dev).float().cpu().numpy()
                for n in word_lengths]
    else:
        tmpl = [torch.randn((n, d), generator=gen, device=dev).cpu().numpy()
                for n in word_lengths]
    rec = DTWRecognizer.from_features(tmpl, device=dev)
    if kind == "negative":
        dist_t = torch.randn((n_frames, rec._templates.shape[0]), generator=gen, device=dev)
        u = torch.rand(dist_t.shape, generator=gen, device=dev)
        dist_t = torch.where(u < 0.1, -0.0, torch.where(u < 0.2, 0.0, dist_t))
        return rec, dist_t
    sample = (torch.as_tensor(tmpl[2], device=dev) if kind == "self"
              else torch.randn((n_frames, d), generator=gen, device=dev))
    dist_t = pairwise_euclidean(sample, rec._templates)
    return rec, dist_t


DTW_CASES = {  # name -> (word lengths, sample frames, kind); a column advances
    # at most 2 template rows, so every case has words the sample can reach
    "digits": ([80, 95, 70, 100, 88, 92, 75, 99, 84, 90, 97], 200, "random"),  # 2 rows a lane
    "2000-rows": ([100] * 20, 120, "random"),  # 4 rows a lane
    "4000-rows": ([200] * 20, 150, "random"),  # 8 rows a lane
    "8000-rows": ([200] * 40, 150, "random"),  # 16 rows a lane, 16 warps
    "8192-rows": ([256] * 32, 150, "random"),  # the earlier kernel's cap
    "8193-rows": ([256] * 32 + [1], 150, "random"),  # past it: 32 rows a lane
    "12000-rows": ([200] * 60, 150, "random"),  # 32 rows a lane, bit masks
    "18000-rows": ([200] * 90, 150, "random"),  # 64 rows a lane, a 3-slot ring
    "20000-rows": ([200] * 100, 150, "random"),  # 64 rows a lane, a 2-slot ring
    "32768-rows": ([256] * 128, 150, "random"),  # the cap: 64 rows a lane, a 1-slot ring
    "h1133": ([103] * 11, 120, "random"),  # H not a multiple of 4: rows re-laid
    "l400": ([80, 95, 70, 100, 88, 92, 75, 99, 84, 90, 97], 400, "random"),  # past the ring
    "zero-distance": ([30, 25, 40, 35], 0, "self"),  # costs of exactly 0, a zero threshold
    "negative": ([60, 45, 70, 50, 64], 90, "negative"),  # negative costs, signed zeros
    "l1": ([40, 1, 60, 2], 1, "random"),
    "one-frame-word": ([1, 30, 1, 1, 25], 40, "random"),
}


@pytest.mark.parametrize("pruning", [True, False])
@pytest.mark.parametrize("case", sorted(DTW_CASES))
def test_dtw_kernel_is_bitwise_plain(dev, case, pruning):
    """The DTW column kernel: ONE launch a sample, costs bitwise
    dtw_columns_plain on the same distances (several runs a lane, past the
    earlier 8,192-row cap up to the 32,768-row one, H off a multiple of 4,
    more columns than the ring holds, exact-zero and negative costs, L = 1,
    one-frame words with no second row)."""
    from cs304_tpu_torch.ops import dtw as dt
    from cs304_tpu_torch.ops.cuda import dtw as cdtw

    lengths, n_frames, kind = DTW_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(11)
    rec, dist_t = dtw_problem(gen, lengths, n_frames, kind=kind)
    for factor in (4.0, 0.05) + ((-0.5,) if kind == "negative" else ()):
        before = cdtw.dtw_columns.launches
        args = (dist_t, rec._is_first, rec._is_second, rec._end_rows, pruning, factor)
        runs = kernel_runs(cdtw.dtw_columns, *args)
        # The recognizer's layout: rows 16 bytes apart, the pad past H poisoned.
        runs += kernel_runs(lambda: cdtw.dtw_columns(
            cdtw.aligned_rows(*dist_t.shape, dev).copy_(dist_t), *args[1:]))
        assert cdtw.dtw_columns.launches == before + 4  # one launch a poison and layout
        want = plain_run(dt.dtw_columns_plain, *args)
        torch.cuda.synchronize()
        for got in runs:
            assert torch.equal(got, want), (got, want)
            if factor == 4.0 and (kind != "negative" or not pruning):
                assert torch.isfinite(got).any()
            if kind == "self":
                assert float(got[2]) == 0.0  # word 2 along its own frames
    # The recognizer on the card against one on the CPU: the distances
    # differ by the two matmuls' rounding only.
    on_card = dt.DTWRecognizer(rec.word_lengths, rec.templates, pruning, device=dev)
    cpu = dt.DTWRecognizer(rec.word_lengths, rec.templates, pruning, device="cpu")
    sample = torch.randn((max(n_frames, 1), 39), generator=gen, device=dev).cpu().numpy()
    np.testing.assert_allclose(on_card.distances(sample), cpu.distances(sample), rtol=1e-5)
    assert on_card.search(sample)[0] == cpu.search(sample)[0]


def test_dtw_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from cs304_tpu_torch.ops.cuda import dtw as cdtw

    gen = torch.Generator(device=dev).manual_seed(2)
    rec, dist_t = dtw_problem(gen, [5, 6], 4)
    args = (rec._is_first, rec._is_second, rec._end_rows)
    with pytest.raises(TypeError):
        cdtw.dtw_columns(dist_t.double(), *args)
    with pytest.raises(ValueError):
        cdtw.dtw_columns(dist_t.T, *args)  # not contiguous
    with pytest.raises(ValueError):
        cdtw.dtw_columns(dist_t[:, :10], *args)  # flags of another H
    with pytest.raises(TypeError):
        cdtw.dtw_columns(dist_t, *args[:2], rec._end_rows.long())
    big = torch.zeros((2, cdtw.MAX_TEMPLATE_ROWS + 1), device=dev)
    flag = torch.zeros((cdtw.MAX_TEMPLATE_ROWS + 1,), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match=str(cdtw.MAX_TEMPLATE_ROWS)):
        cdtw.dtw_columns(big, flag, flag, rec._end_rows)


def test_tie_pooling_is_fixed_order_on_the_card(dev):
    """_pool_slots on a CUDA tensor sums each tie group in ascending row
    order: bitwise a sequential scatter-add on the CPU, in every call, for
    even groups and for one large group among singletons."""
    from cs304_tpu_torch.models.train_fused import _pool_slots, tie_plan

    rng = np.random.default_rng(3)
    for n, skewed in ((1, False), (7, False), (330, False), (330, True)):
        tie = (np.where(rng.random(n) < 0.5, 0, np.arange(n)) if skewed
               else rng.integers(0, max(n // 3, 1), n))
        stat = torch.from_numpy(rng.normal(size=(n, 39, 39)).astype(np.float32))
        t = torch.from_numpy(tie)
        want = torch.zeros_like(stat).index_add_(0, t, stat)[t]
        plan = tie_plan(tie, dev)
        first = _pool_slots(stat.to(dev), plan)
        again = _pool_slots(stat.to(dev), t.to(dev))
        assert torch.equal(first.cpu(), want) and torch.equal(again.cpu(), want)


@pytest.mark.parametrize("update", ["viterbi", "baum_welch"])
def test_tied_training_is_bitwise_reproducible_on_the_card(dev, update):
    """Two ContinuousTrainer runs with state and transition ties on the card
    give bitwise equal parameters (tie pooling has no float atomics)."""
    from cs304_tpu_torch.models.train_continuous import (
        ContinuousTrainConfig,
        ContinuousTrainer,
        insert_silence,
    )

    models = {m.label: m for m in flagship_models(seed=0)}
    rng = np.random.default_rng(4)
    labeled = {}
    for tr in ("14", "27Z", "3", "5698"):
        feats = []
        for _ in range(8):
            frames = [models[w].means[i] + rng.normal(0, 0.7, size=(3, 39))
                      for w in insert_silence(tr) for i in range(models[w].num_states)]
            feats.append(np.concatenate(frames).astype(np.float32))
        labeled[tr] = feats
    digits = [lab for lab in models if lab != "S"]
    state_ties = {(lab, st): f"g{st}-{i % 3}" for i, lab in enumerate(digits)
                  for st in range(models[lab].num_states)}
    trans_ties = {lab: i % 2 for i, lab in enumerate(digits)}
    cfg = ContinuousTrainConfig(max_iterations=3, cov_reg=0.05, update=update,
                                silence_bootstrap=False)
    runs = []
    for _ in range(2):
        tr = ContinuousTrainer(models, cfg, state_ties=state_ties,
                               transition_ties=trans_ties, device=dev)
        tr.train(labeled)
        runs.append(tr)
    for name in ("means_g", "covs_g", "log_a_g"):
        a, b = getattr(runs[0], name), getattr(runs[1], name)
        assert np.array_equal(a, b, equal_nan=True), name
    i0, i3 = runs[0].label_index[digits[0]], runs[0].label_index[digits[3]]
    assert np.array_equal(runs[0].means_g[i0, 1], runs[0].means_g[i3, 1])


@pytest.mark.parametrize("extra", [[], ["--confidence", "--timings"]])
def test_transcribe_card_equals_cpu(dev, tmp_path, extra):
    """The transcribe script on a 3-word checkpoint and two 3-digit WAVs:
    --device cuda prints the lines --device cpu prints (transcripts, and
    with --confidence --timings the same confidences and word times), the
    decode kernel (K2, or K4 + K2-bt for the confidences) launched on the
    card and no card kernel in the CPU run."""
    from cs304_tpu_torch.audio.wav import write_wav_int16
    from cs304_tpu_torch.data.synthetic import SyntheticTIDigits
    from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig, train_word_hmm
    from cs304_tpu_torch.ops.mfcc import mfcc_batch
    from cs304_tpu_torch.scripts import transcribe
    from cs304_tpu_torch.scripts._common import run_in_process
    from cs304_tpu_torch.utils.checkpoint import save_models

    corpus = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1, takes_per_digit=2)
    cfg = SegmentalKMeansConfig(num_states=5, max_iterations=4, length_multiple=32)
    save_models({w: train_word_hmm(w, mfcc_batch(corpus.train_dataset[w], device=dev), cfg,
                                   device=dev).model for w in "357"}, str(tmp_path / "ckpt"))
    argv = ["--checkpoint-dir", str(tmp_path / "ckpt"), "--log-file", str(tmp_path / "rt.log")]
    for text, seed in (("375", 3), ("753", 4)):
        write_wav_int16(str(tmp_path / f"{text}.wav"),
                        corpus.sentence_audio(text, 0, jitter_seed=seed), 16000)
        argv += ["--wav", str(tmp_path / f"{text}.wav")]
    kernels = (tsf.scanfree_decode, tdn.trellis_dense_forward, tsf.trellis_backtrace)
    out = {}
    for device in ("cuda", "cpu"):
        for k in kernels:
            k.launches = 0
        out[device] = run_in_process(transcribe.main, argv + extra + ["--device", device])
        torch.cuda.synchronize()
        out[device, "launches"] = [k.launches for k in kernels]
    # Transcripts and word times equal; a confidence moves in steps of
    # float32 ulps of |log Z| (2^-8 at these utterances): 4 ulps and the
    # print's rounding, as phase 22 holds the card's confidences.
    got, want = out["cuda"].splitlines(), out["cpu"].splitlines()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g_conf, w_conf = (re.findall(r"\[([\d.]+)", x) for x in (g, w))
        assert re.sub(r"\[[\d.]+", "[", g) == re.sub(r"\[[\d.]+", "[", w)
        assert all(abs(float(a) - float(b)) <= 4 * 2.0 ** -8 + 1e-3
                   for a, b in zip(g_conf, w_conf))
    assert out["cpu", "launches"] == [0, 0, 0]
    if extra:
        assert out["cuda", "launches"][1] > 0 and out["cuda", "launches"][2] > 0
    else:
        assert out["cuda", "launches"][0] > 0


# -- the constrained searches: PLANES (counted, grammar) and DURATION ---------
# chip_smoke.py's PIPELINE_TRANSCRIPTS: the 6-string menu grammar.
MENU = ["12", "4Z", "375", "9O2", "186Z", "54321"]

# name: (num_words (None: the flagship), B, T, kind, its argument, tie-heavy
# log_b[, options: "edges" (the last row of length 0), "penalty" (in place
# of the composite's)]). counted: (N, n_words_min);
# grammar: "menu" or "positions" (three positions of random word subsets);
# duration: (min, max). Each case's branch (planes_plan / duration_plan) is
# in CONSTRAINED_BRANCH: the flagship's planes are one warp each, 503 states
# (not a multiple of 32 K) four warps a plane, N = 9 at 503 states two CTAs
# of a cluster, 5003 states one CTA a plane (a cluster of three or four);
# DURATION's teams hold 8 slots at 503 and 5003 states (d_cap = 8, the
# 5003-state slots in shared memory), and 5003 states at D = 6 (30,018
# cells, which the simple branch walked in its forward past K2-bt's 29,048)
# are walked by the team; 103 states are one warp of four states (a
# plane, a DURATION team); 11 planes at 503 states leave a cluster's last
# CTA a plane idle; a zero penalty takes the exits' butterflies (PLANES)
# and the best-two path (DURATION). "k2bt-edge" (500 planes x 58 states, 29,000
# cells) and "walk-edge" (501 planes, 29,058 cells) have more planes than a
# cross code names: the simple branch, walked by K2-bt and by its forward;
# D = 9 is past a team's slots: the simple branch, walked by K2-bt at 503
# states (4,527 cells) and by its forward at 5003 (45,027).
CONSTRAINED_CASES = {
    **{f"counted-{n}": (None, 16, 120, "counted", (n, None), False) for n in range(1, 8)},
    "counted-range": (None, 16, 120, "counted", (5, 2), False),
    "counted-ties": (None, 16, 80, "counted", (3, None), True),
    "counted-b1": (None, 1, 60, "counted", (2, None), False),
    "counted-t1": (None, 4, 1, "counted", (1, None), False, {"edges": True}),
    "grammar-menu": (None, 16, 120, "grammar", "menu", False),
    "grammar-menu-ties": (None, 16, 80, "grammar", "menu", True),
    "duration-min2": (None, 16, 120, "duration", (2, None), False),
    "duration-min3-max6": (None, 16, 120, "duration", (3, 6), False),
    "duration-ties": (None, 16, 80, "duration", (2, 4), True),
    "duration-b1": (None, 1, 60, "duration", (2, None), False),
    "duration-t1": (None, 5, 1, "duration", (2, None), False, {"edges": True}),
    "duration-edges": (None, 6, 40, "duration", (2, 3), False, {"edges": True}),
    "counted-103": (20, 8, 80, "counted", (3, None), False),
    "duration-103": (20, 8, 80, "duration", (2, 5), False),
    "grammar-menu-zero-penalty": (None, 16, 80, "grammar", "menu", True, {"penalty": 0.0}),
    "duration-zero-penalty": (None, 16, 80, "duration", (2, None), True, {"penalty": 0.0}),
    "counted-503": (100, 8, 120, "counted", (4, None), False),
    "counted-503-idle-plane": (100, 2, 40, "counted", (10, None), False),
    "counted-503-zero-penalty": (100, 4, 60, "counted", (3, None), False, {"penalty": 0.0}),
    "duration-503-zero-penalty": (100, 4, 60, "duration", (2, None), False, {"penalty": 0.0}),
    "counted-503-cluster": (100, 4, 60, "counted", (9, None), False, {"edges": True}),
    "grammar-503": (100, 8, 120, "grammar", "positions", False),
    "duration-503": (100, 8, 120, "duration", (3, 6), False),
    "duration-503-d8": (100, 4, 80, "duration", (3, 8), False, {"edges": True}),
    "counted-5003": (1000, 2, 30, "counted", (2, None), False),
    "counted-5003-b1": (1000, 1, 20, "counted", (3, None), False),
    "grammar-5003": (1000, 2, 30, "grammar", "positions", False),
    "duration-5003": (1000, 2, 30, "duration", (2, None), False),
    "duration-5003-walk": (1000, 2, 40, "duration", (3, 6), False),
    "duration-5003-d8": (1000, 2, 40, "duration", (3, 8), False, {"edges": True}),
    "k2bt-edge": (None, 1, 20, "counted", (499, 1), False),
    "walk-edge": (None, 1, 20, "counted", (500, 1), False),
    "duration-503-d9": (100, 4, 60, "duration", (3, 9), False),
    "duration-5003-d9": (1000, 2, 30, "duration", (3, 9), False),
}
CONSTRAINED_BRANCH = {
    **{c: "team" for c in CONSTRAINED_CASES},
    "counted-503-cluster": "cluster", "counted-503-idle-plane": "cluster",
    "counted-5003": "cluster", "counted-5003-b1": "cluster",
    "grammar-5003": "cluster", "k2bt-edge": "simple", "walk-edge": "simple",
    "duration-503-d9": "simple", "duration-5003-d9": "simple",
}


def _constrained_problem(dev, case):
    """(composite, log_b, lengths, run(log_b, lengths) on the dispatchers,
    plain(log_b, lengths), counter, plan, cells, simple(log_b, lengths) on
    the forced simple branch, PR 19's kernel and K2-bt)."""
    from cs304_tpu_torch.ops import grammar as tg
    from cs304_tpu_torch.ops import viterbi_counted as tvc
    from cs304_tpu_torch.ops import viterbi_duration as tvd
    from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs

    words, b, t, kind, arg, ties, *opts = CONSTRAINED_CASES[case]
    opts = opts[0] if opts else {}
    comp = flagship_composite() if words is None else _composite(words)
    pen = opts.get("penalty", comp.penalty)
    s = comp.num_states
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    gen = torch.Generator(device=dev).manual_seed(len(case))
    if ties:
        log_b = torch.randint(-3, 1, (b, t, s), generator=gen, device=dev).float()
    else:
        log_b = 3 * torch.randn((b, t, s), generator=gen, device=dev)
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0] = t
    if b > 2:
        lengths[1] = 1
    if opts.get("edges"):
        lengths[-1] = 0
    if kind == "counted":
        n, n_min = arg
        counted = comp.word_of_state != comp.labels.index("S")
        word, ns, acc = tvc.chain_grammar(counted, n, n_min)
        return comp, log_b, lengths, (lambda lb, ln: tvc.viterbi_composite_counted_batch(
            lb, *topo, counted, pen, n, ln, n_words_min=n_min)), (
            lambda lb, ln: tvc.viterbi_composite_counted_batch_plain(
                lb, *topo, counted, pen, n, ln, n_words_min=n_min)), \
            tcs.planes_decode, tcs.planes_plan(t, s, n + 1), (n + 1) * s, \
            lambda lb, ln: tcs.forward_branch(
                True, lb, tcs.planes_operands(*topo, word, ns, acc, dev), pen, ln,
                simple=True)
    if kind == "grammar":
        if arg == "menu":
            dfa = tg.WordDFA.from_strings(MENU, comp.labels)
        else:
            rng = np.random.default_rng(s)
            vocab = [lab for lab in comp.labels if lab != "S"]
            dfa = tg.WordDFA.from_positions(
                [tuple(rng.choice(vocab, size=len(vocab) // 3, replace=False))
                 for _ in range(3)], comp.labels)
        args = (*topo, comp.word_of_state, dfa.next_state, dfa.accept, pen)
        return comp, log_b, lengths, (
            lambda lb, ln: tg.viterbi_composite_grammar_batch(lb, *args, ln)), (
            lambda lb, ln: tg.viterbi_composite_grammar_batch_plain(lb, *args, ln)), \
            tcs.planes_decode, tcs.planes_plan(t, s, dfa.num_planes), dfa.num_planes * s, \
            lambda lb, ln: tcs.forward_branch(True, lb, tcs.planes_operands(*args[:-1], dev),
                                              pen, ln, simple=True)
    min_dur, max_dur, d_cap = tvd.duration_arrays(comp, *arg)
    args = (*topo, pen, min_dur, max_dur)
    return comp, log_b, lengths, (
        lambda lb, ln: tvd.viterbi_composite_duration_batch(lb, *args, ln, d_cap=d_cap)), (
        lambda lb, ln: tvd.viterbi_composite_duration_batch_plain(lb, *args, ln,
                                                                  d_cap=d_cap)), \
        tcs.duration_decode, tcs.duration_plan(t, s, d_cap), s * d_cap, \
        lambda lb, ln: tcs.forward_branch(
            False, lb, tcs.duration_operands(*topo, min_dur, max_dur, d_cap, dev), pen,
            ln, simple=True)


def _same_as_plain(got, want):
    """Scores bitwise (signs of zero too), paths on every finite row."""
    finite = torch.isfinite(want[0])
    assert torch.equal(got[0], want[0])
    assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))
    assert torch.equal(got[1][finite], want[1][finite])
    return finite


@pytest.mark.parametrize("case", sorted(CONSTRAINED_CASES))
def test_constrained_kernels_are_bitwise_plain(dev, case):
    from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs

    _comp, log_b, lengths, run, plain, counter, plan, cells, simple = _constrained_problem(
        dev, case)
    assert plan["branch"] == CONSTRAINED_BRANCH[case]
    k2bt = plan["branch"] == "simple" and cells <= tcs.k2bt_max_cells(dev)
    before = (counter.launches, tsf.trellis_backtrace.launches)
    runs = kernel_runs(run, log_b, lengths)
    torch.cuda.synchronize()
    assert counter.launches == before[0] + 2  # one launch a poison
    assert tsf.trellis_backtrace.launches == before[1] + 2 * int(k2bt)
    want = plain_run(plain, log_b, lengths)
    for got in runs:
        finite = _same_as_plain(got, want)
    # No composite here has a one-frame path (T = 1 compares -inf rows;
    # test_constrained_kernels_take_edge_lengths_and_inf has one).
    assert finite.any() or log_b.shape[1] == 1
    if case.startswith(("counted-7", "duration-min3")):
        assert not finite.all()  # rows too short for any admissible path
    # A column slice of a padded tensor is read in place, at its row stride.
    padded = torch.zeros((*log_b.shape[:2], log_b.shape[2] + 5), device=dev)
    padded[..., : log_b.shape[2]] = log_b
    for g in kernel_runs(run, padded[..., : log_b.shape[2]], lengths):
        _same_as_plain(g, want)
    if plan["branch"] != "simple":
        # The simple branch (PR 19's kernel and K2-bt) on the same inputs:
        # the same scores and paths.
        for g in kernel_runs(simple, log_b, lengths):
            _same_as_plain(g, want)


def test_constrained_team_instance_follows_the_plan(dev):
    """The team kernel's template arguments as the library reports them:
    states a lane by S, a cluster past one CTA, redux keys at a non-zero
    penalty (PLANES); the slot pitch, shared slots at K = 8 from 4 slots,
    the best two where an entry is an exit or the penalty is zero
    (DURATION); None on the simple branch."""
    from types import SimpleNamespace

    from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs

    def inst(planes, s, depth, t, penalty, entry_exit=False):
        tabs = SimpleNamespace(s=s, depth=depth, entry_exit=entry_exit)
        return tcs.team_instance(planes, tabs, t, penalty)

    assert inst(True, 58, 8, 201, -100.0) == (2, 0, 1, 0)
    assert inst(True, 58, 8, 201, 0.0) == (2, 0, 0, 0)
    assert inst(True, 503, 5, 201, -1.0) == (4, 0, 1, 0)
    assert inst(True, 5003, 3, 60, -100.0) == (8, 1, 1, 0)
    assert inst(True, 58, 65, 60, -100.0) is None
    assert inst(False, 58, 2, 201, -100.0) == (2, 2, 0, 0)
    assert inst(False, 58, 2, 201, -100.0, entry_exit=True) == (2, 2, 0, 1)
    assert inst(False, 58, 2, 201, 0.0) == (2, 2, 0, 1)
    assert inst(False, 503, 5, 201, -1.0) == (4, 6, 0, 0)
    assert inst(False, 5003, 8, 60, -1.0) == (8, 8, 1, 0)
    assert inst(False, 5003, 9, 60, -1.0) is None


def test_constrained_kernels_break_ties_as_the_plain_versions(dev):
    """A grammar whose cross move has two source planes and a duration
    advance whose exits' sums tie, both under a -3e9 penalty (the max over
    raw alpha, then the add, for the planes; the sums compared for the
    advance)."""
    from test_torch_constrained_kernels import COMPOSITES, _grammars, sum_tie_problem

    from cs304_tpu_torch.ops import grammar as tg
    from cs304_tpu_torch.ops import viterbi_duration as tvd

    comp = COMPOSITES["huge-penalty"]()
    dfa = _grammars(comp.labels)["merge"]
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    rng = np.random.default_rng(3)
    lengths = torch.as_tensor(np.asarray([13, 8, 2, 13, 1, 5] * 16, np.int32), device=dev)
    log_b = torch.as_tensor((rng.normal(size=(96, 13, comp.num_states)) * 3).astype(np.float32),
                            device=dev)
    args = (*topo, comp.word_of_state, dfa.next_state, dfa.accept, comp.penalty, lengths)
    want = plain_run(tg.viterbi_composite_grammar_batch_plain, log_b, *args)
    for got in kernel_runs(tg.viterbi_composite_grammar_batch, log_b, *args):
        _same_as_plain(got, want)
    comp, lb, ln, min_dur, max_dur, d_cap = sum_tie_problem()
    args = (torch.as_tensor(lb, device=dev), comp.log_a, comp.lower_of_state, comp.is_entry,
            comp.is_exit, comp.penalty, min_dur, max_dur, torch.as_tensor(ln, device=dev))
    want = plain_run(tvd.viterbi_composite_duration_batch_plain, *args, d_cap=d_cap)
    for got in kernel_runs(tvd.viterbi_composite_duration_batch, *args, d_cap=d_cap):
        _same_as_plain(got, want)
        assert got[1][0, :3].tolist() == [0, 1, 4]


@pytest.mark.parametrize("t", [1, 7])
def test_constrained_kernels_take_edge_lengths_and_inf(dev, t):
    """T = 1, lengths 0, -1, 1 and past T, -inf sprinkled in log_b, on a
    composite with a one-state word (a path of one frame exists): the
    counted, grammar and duration dispatchers bitwise their plain
    versions."""
    from test_torch_constrained_kernels import COMPOSITES

    from cs304_tpu_torch.ops import grammar as tg
    from cs304_tpu_torch.ops import viterbi_counted as tvc
    from cs304_tpu_torch.ops import viterbi_duration as tvd

    comp = COMPOSITES["one-state-word"]()
    s = comp.num_states
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    gen = torch.Generator(device=dev).manual_seed(t)
    log_b = 3 * torch.randn((8, t, s), generator=gen, device=dev)
    log_b[torch.rand((8, t, s), generator=gen, device=dev) < 0.1] = float("-inf")
    lengths = torch.tensor([t, 0, -1, 1, t + 3, t, 1, t], dtype=torch.int32, device=dev)
    counted = comp.word_of_state != comp.labels.index("S")
    dfa = tg.WordDFA.from_strings(["2", "21", "312"], comp.labels)
    one = np.ones(s, np.int32)
    runs = (
        (lambda f, lb: f(lb, *topo, counted, comp.penalty, 1, lengths),
         tvc.viterbi_composite_counted_batch, tvc.viterbi_composite_counted_batch_plain),
        (lambda f, lb: f(lb, *topo, comp.word_of_state, dfa.next_state, dfa.accept,
                         comp.penalty, lengths),
         tg.viterbi_composite_grammar_batch, tg.viterbi_composite_grammar_batch_plain),
        (lambda f, lb: f(lb, *topo, comp.penalty, one, np.full(s, tvd.UNBOUNDED), lengths,
                         d_cap=2),
         tvd.viterbi_composite_duration_batch, tvd.viterbi_composite_duration_batch_plain),
    )
    for call, kernel, plain in runs:
        want = plain_run(call, plain, log_b)
        for got in kernel_runs(call, kernel, log_b):
            assert _same_as_plain(got, want).any()


def _sampled_clips(n, seed):
    """Flagship-model frames along random word sequences (1-4 words)."""
    rng = np.random.default_rng(seed)
    models = flagship_models()
    out = []
    for _ in range(n):
        frames = []
        for _ in range(int(rng.integers(1, 5))):
            m = models[int(rng.integers(len(models)))]
            for st in range(m.num_states):
                k = int(rng.integers(2, 6))
                frames.append(m.means[st] + 0.7 * rng.normal(size=(k, m.means.shape[1])))
        out.append(np.concatenate(frames).astype(np.float32))
    return out


@pytest.mark.parametrize("gmm", [False, True])
def test_constrained_decoders_launch_their_kernels_not_the_plain(dev, monkeypatch, gmm):
    """predict_batch_counted / _grammar / _duration on the card, single
    Gaussians and a K=2 GMM: the CPU decoder's transcripts, the PLANES or
    DURATION kernel launched and no K2-bt (the kernels walk their codes),
    no plain trellis on a CUDA tensor; the single-utterance trellises
    launch them too."""
    from cs304_tpu_torch.models import decoder as dm
    from cs304_tpu_torch.models.train_continuous_gmm import promote_to_gmm
    from cs304_tpu_torch.ops import grammar as tg
    from cs304_tpu_torch.ops import viterbi_counted as tvc
    from cs304_tpu_torch.ops import viterbi_duration as tvd
    from cs304_tpu_torch.ops.cuda import trellis_constrained as tcs

    models = flagship_models()
    if gmm:
        models = promote_to_gmm({m.label: m for m in models}, 2, jitter=0.3, seed=1)
    clips = _sampled_clips(12, 7)
    labels = flagship_composite().labels
    menu = tg.WordDFA.from_strings(MENU + ["7", "38"], labels)
    runs = {
        "counted": (lambda d: d.predict_batch_counted(clips, 2), tcs.planes_decode),
        "grammar": (lambda d: d.predict_batch_grammar(clips, menu), tcs.planes_decode),
        "duration": (lambda d: d.predict_batch_duration(clips, 2, {"1": 6}),
                     tcs.duration_decode),
    }
    cpu = dm.ContinuousDecoder(models, penalty=-100.0, device="cpu")
    want = {k: fn(cpu) for k, (fn, _c) in runs.items()}
    comp = flagship_composite()
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    one = 3 * torch.randn((40, comp.num_states), generator=torch.Generator().manual_seed(9))
    counted = comp.word_of_state != comp.labels.index("S")
    min_dur, max_dur, d_cap = tvd.duration_arrays(comp, 2)
    singles = {
        "counted": (lambda lb: tvc.viterbi_composite_counted(
            lb, *topo, counted, comp.penalty, 2, length=31), tcs.planes_decode),
        "grammar": (lambda lb: tg.viterbi_composite_grammar(
            lb, *topo, comp.word_of_state, menu.next_state, menu.accept, comp.penalty),
            tcs.planes_decode),
        "duration": (lambda lb: tvd.viterbi_composite_duration(
            lb, *topo, comp.penalty, min_dur, max_dur, d_cap=d_cap), tcs.duration_decode),
    }
    want_single = {k: fn(one) for k, (fn, _c) in singles.items()}

    def plain_on_card(*args, **kwargs):
        raise AssertionError("a plain constrained trellis ran on the card")

    for mod, name in ((tvc, "viterbi_composite_counted_batch_plain"),
                      (tg, "viterbi_composite_grammar_batch_plain"),
                      (tvd, "viterbi_composite_duration_batch_plain")):
        monkeypatch.setattr(mod, name, plain_on_card)
    card = dm.ContinuousDecoder(models, penalty=-100.0, device="cuda")
    for what, (fn, counter) in runs.items():
        before = (counter.launches, tsf.trellis_backtrace.launches)
        assert fn(card) == want[what], what
        assert counter.launches > before[0] and tsf.trellis_backtrace.launches == before[1]
    for what, (fn, counter) in singles.items():
        before = counter.launches
        score, path = fn(one.to(dev))
        assert counter.launches == before + 1, what
        assert torch.isfinite(want_single[what][0]), what
        assert score.item() == want_single[what][0].item(), what
        assert torch.equal(path.cpu(), want_single[what][1]), what


# -- the posterior and n-best searches: LSUM, LMAX and KBEST -----------------
def _lattice_composite(counts, penalty):
    rng = np.random.default_rng(31)
    return stack_word_models(
        [WordHMM(f"w{i}", rng.normal(size=(n, 4)).astype(np.float32),
                 np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)), uniform_forward_log_a(n))
         for i, n in enumerate(counts)], penalty=penalty)


# name: (composite (None: the flagship), B, T, integer-valued log_b); the
# single-state words' self-loop (0) beats a -25 penalty and a 0 penalty
# beats it; 503, 1503, 3003 and 5003 states (LSUM's factorized pools, at 8
# states a band thread at 5003; KBEST past 32 exits on the simple branch,
# its rows in a device scratch at K = 16; LMAX at 1, 2 and 4 states a band
# thread and on a cluster); pools of 1, 31, 32 and 33 members around
# DENSE_POOL_MAX (KBEST's team branch up to 32 exit rows).
LATTICE_CASES = {
    "flagship": (None, 16, 120, False),
    "flagship-ties": (None, 16, 60, True),
    "single-state-words": (([1, 3, 1, 5, 1, 3], -25.0), 8, 50, True),
    "single-state-pool-beats": (([1, 3, 1, 5, 1, 3], 0.0), 8, 50, True),
    "503": (([5] * 100 + [3], -100.0), 4, 80, False),
    "1503": (([5] * 300 + [3], -100.0), 2, 40, False),
    "3003": (([5] * 600 + [3], -100.0), 2, 30, False),
    "5003": (([5] * 1000 + [3], -100.0), 2, 30, False),
    "pool-1": (([2], -25.0), 4, 40, False),
    "pool-31": (([2, 1] * 15 + [3], -25.0), 4, 40, True),
    "pool-32": (([2, 1] * 16, 0.0), 4, 40, True),
    "pool-33": (([2, 1] * 16 + [3], -25.0), 4, 40, False),
}
# KBEST's K: every bucket (1, 2, 4, 8, 16, 32; 6 in the 8 bucket) and one
# past the largest (the simple branch).
KBEST_KS = (1, 2, 4, 6, 8, 16, 32, 33)
# LMAX's team plan at each case: (states a band thread, the pool, cells a
# pool lane, CTAs a pass). The pool is dense up to 32 exits and entries (one
# pool warp reading them after the barrier), factorized past them; 5003
# states take a cluster of two CTAs a pass (one CTA's band would need more
# than 4 states a thread).
_DENSE1 = (1, "dense", 1, 1)
LMAX_PLANS = {"flagship": _DENSE1, "flagship-ties": _DENSE1, "single-state-words": _DENSE1,
              "single-state-pool-beats": _DENSE1, "503": (1, "factorized", 1, 1),
              "1503": (2, "factorized", 2, 1), "3003": (4, "factorized", 4, 1),
              "5003": (4, "factorized", 4, 2), "pool-1": _DENSE1, "pool-31": _DENSE1,
              "pool-32": _DENSE1, "pool-33": (1, "factorized", 1, 1)}
# Every other build of LMAX's team branch (lattice_max_team_kernel<states a
# band thread, dense pool, cells a pool lane, CTAs>) on a composite whose
# plan takes it: word state counts -> (branch, that plan). A dense pool of
# long words past 4 states a band thread is folded on a cluster like a
# factorized one. Past twice the first design's states a thread in cells a
# pool lane the first design stays (the simple cases).
LMAX_BUILDS = {
    "k1-cells2": ([2] * 300, ("team", 1, "factorized", 2, 1)),
    "simple-700-single-state-words": ([1] * 700, ("simple", 1, "factorized", 1, 1)),
    "k2-dense": ([50] * 30, ("team", 2, "dense", 1, 1)),
    "k2-cells1": ([10] * 150, ("team", 2, "factorized", 1, 1)),
    "k2-cells4": ([2] * 700, ("team", 2, "factorized", 4, 1)),
    "simple-1100-single-state-words": ([1] * 1100, ("simple", 2, "factorized", 1, 1)),
    "k4-dense": ([100] * 30, ("team", 4, "dense", 1, 1)),
    "k4-cells1": ([20] * 150, ("team", 4, "factorized", 1, 1)),
    "k4-cells2": ([7] * 400, ("team", 4, "factorized", 2, 1)),
    "k4-cells8": ([2] * 1100, ("team", 4, "factorized", 8, 1)),
    "cluster2-long-words": ([250] * 20, ("team", 4, "factorized", 1, 2)),
    "cluster2-cells2": ([12] * 400, ("team", 4, "factorized", 2, 2)),
    "cluster2-cells8": ([4] * 1100, ("team", 4, "factorized", 8, 2)),
    "cluster4-long-words": ([400] * 20, ("team", 4, "factorized", 1, 4)),
    "cluster4-cells2": ([20] * 400, ("team", 4, "factorized", 2, 4)),
    "cluster4-cells4": ([8] * 1000, ("team", 4, "factorized", 4, 4)),
}


def _lmax_plan_key(plan):
    return plan["branch"], plan["k"], plan["pool"], plan["cells_a_lane"], plan["ctas"]


def _bits_equal(a, b):
    """Equal values with their signs of zero (floats), or equal integers
    (chip_smoke.tensor_bits_equal)."""
    if a.dtype.is_floating_point:
        return torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))
    return torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(LATTICE_CASES))
def test_lattice_kernels_match_plain(dev, case):
    """LSUM against lattice_sum_passes_plain (the same -inf cells, the rest
    within 1e-5 * max(1, |x|), every row with a length-2 and a length-1
    row), LMAX (signs of zero included) and KBEST (K = 1, 2, 4, 6, 8, 16,
    32, 33; T = 1) bitwise theirs, one launch each; each on the branch its
    plan takes and on the forced simple branch (the first design); LMAX's
    plan the team branch with the case's pool."""
    from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk

    spec, b, t, ties = LATTICE_CASES[case]
    comp = flagship_composite() if spec is None else _lattice_composite(*spec)
    topo = tlk.lattice_topology(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                                comp.word_of_state, device=dev)
    gen = torch.Generator(device=dev).manual_seed(len(case))
    s, n_x, n_e = comp.num_states, topo.exits.numel(), topo.entries.numel()
    lb = (torch.randint(-3, 1, (b, t, s), generator=gen, device=dev).float() if ties
          else 3 * torch.randn((b, t, s), generator=gen, device=dev))
    lengths = torch.randint(2, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = t, 2
    counters = (tlk.lattice_sum_passes, tlk.lattice_max_passes, tlk.kbest_forward)
    before = [c.launches for c in counters]
    assert tlk.lattice_sum_plan(s, n_x, n_e)["branch"] == "team"
    want = plain_run(tlk.lattice_sum_passes_plain, lb, topo, comp.penalty, lengths)
    for simple in (False, True):
        for got in kernel_runs(tlk.lattice_sum_passes, lb, topo, comp.penalty, lengths,
                               simple=simple):
            for g, w in zip(got, want):
                assert torch.equal(torch.isfinite(g), torch.isfinite(w))
                fin = torch.isfinite(w)
                assert ((g - w)[fin].abs() <= 1e-5 * w[fin].abs().clamp(min=1.0)).all()
    assert torch.isfinite(want[3]).all()
    plan = tlk.lattice_max_plan(s, n_x, n_e)
    assert _lmax_plan_key(plan) == ("team", *LMAX_PLANS[case]), plan
    for length in (t, 2):
        want = plain_run(tlk.lattice_max_passes_plain, lb[0], topo, comp.penalty, length)
        for simple in (False, True):
            for got in kernel_runs(tlk.lattice_max_passes, lb[0], topo, comp.penalty, length,
                                   simple=simple):
                assert all(_bits_equal(g, w) for g, w in zip(got, want)), (length, simple)
    runs = [(k, t, False) for k in KBEST_KS] + [(8, 1, False), (16, t, True), (33, 1, False)]
    for k, tt, simple in runs:
        branch = tlk.kbest_plan(s, k, n_x)["branch"]
        if k > 32 or s < 1000:  # past K = 32 the first design; else rows fit shared memory
            assert branch == ("team" if k <= 32 else "simple"), (k, branch)
        one = lb[1, :tt].contiguous()
        want = plain_run(tlk.kbest_forward_plain, one, topo, comp.penalty, k, tt - 3)
        for got in kernel_runs(tlk.kbest_forward, one, topo, comp.penalty, k, tt - 3,
                               simple=simple):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (k, tt,
                                                                                  simple)
    after = [c.launches for c in counters]
    # One launch a poison.
    assert [a - b_ for a, b_ in zip(after, before)] == [2 * 2, 2 * 4, 2 * len(runs)]


def test_lattice_max_at_its_widest(dev):
    """LMAX near MAX_LATTICE_STATES (8188 states, 1638 words: the team
    branch on a cluster of four CTAs a pass, 4 states a band thread and 8
    pool warps each) bitwise its plain version on both branches, at the
    full length and a shorter one."""
    from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk

    comp = _lattice_composite([5] * 1637 + [3], -100.0)
    topo = tlk.lattice_topology(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                                comp.word_of_state, device=dev)
    s = comp.num_states
    plan = tlk.lattice_max_plan(s, topo.exits.numel(), topo.entries.numel())
    assert s == 8188 and (plan["branch"], plan["k"], plan["pool_warps"], plan["ctas"]) == (
        "team", 4, 8, 4), plan
    gen = torch.Generator(device=dev).manual_seed(8188)
    lb = 3 * torch.randn((30, s), generator=gen, device=dev)
    for length in (30, 17):
        want = plain_run(tlk.lattice_max_passes_plain, lb, topo, comp.penalty, length)
        assert torch.isfinite(want[3])
        for simple in (False, True):
            for got in kernel_runs(tlk.lattice_max_passes, lb, topo, comp.penalty, length,
                                   simple=simple):
                assert all(_bits_equal(g, w) for g, w in zip(got, want)), (length, simple)


@pytest.mark.parametrize("build", sorted(LMAX_BUILDS))
def test_lattice_max_team_builds_match_plain(dev, build):
    """Each build of LMAX's team branch that LATTICE_CASES and the widest
    case leave out, and the pools whose lanes would hold too many cells
    for it (LMAX_BUILDS, the plan asserted), bitwise the plain version,
    signs of zero included, on the planned branch and on the simple one:
    random emissions at the full length, integer-valued ones (ties) at two
    thirds of it; T at least a word's states, so that every word can be
    walked through."""
    from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk

    counts, want_plan = LMAX_BUILDS[build]
    comp = _lattice_composite(counts, -100.0)
    topo = tlk.lattice_topology(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                                comp.word_of_state, device=dev)
    s = comp.num_states
    plan = tlk.lattice_max_plan(s, topo.exits.numel(), topo.entries.numel())
    assert _lmax_plan_key(plan) == want_plan, plan
    gen = torch.Generator(device=dev).manual_seed(s)
    t = max(16, max(counts))
    inputs = ((3 * torch.randn((t, s), generator=gen, device=dev), t),
              (torch.randint(-3, 1, (t, s), generator=gen, device=dev).float(), 2 * t // 3))
    for lb, length in inputs:
        want = plain_run(tlk.lattice_max_passes_plain, lb, topo, comp.penalty, length)
        assert torch.isfinite(want[3])
        for simple in (False, True):
            for got in kernel_runs(tlk.lattice_max_passes, lb, topo, comp.penalty, length,
                                   simple=simple):
                assert all(_bits_equal(g, w) for g, w in zip(got, want)), (length, simple)


def test_posterior_and_nbest_searches_launch_their_kernels(dev, monkeypatch):
    """The decoder's confidences (LSUM), n-best (KBEST), the forward
    lattice and keyword spotting (LMAX and LSUM) on the card: the CPU
    decoder's transcripts, confidences within 1e-4 (or 4 float32 ulps of
    |log Z|'s scale, 4e-3), the forward lattice's arcs equal; no plain
    loop on a CUDA tensor."""
    from cs304_tpu_torch.models import decoder as dm
    from cs304_tpu_torch.ops import lattice as tla
    from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk

    models = flagship_models()
    clips = _sampled_clips(8, 5)
    cpu = dm.ContinuousDecoder(models, penalty=-100.0, device="cpu")
    want_conf = cpu.predict_batch_with_confidence(clips)
    want_nbest = cpu.predict_nbest(clips[0], n=3)
    want_lat = tla.forward_lattice(cpu.composite, clips[0], posteriors=True, device="cpu")

    def plain_on_card(*args, **kwargs):
        raise AssertionError("a plain posterior or n-best loop ran on the card")

    for name in ("lattice_sum_passes_plain", "lattice_max_passes_plain",
                 "kbest_forward_plain"):
        monkeypatch.setattr(tlk, name, plain_on_card)
    counters = (tlk.lattice_sum_passes, tlk.lattice_max_passes, tlk.kbest_forward)
    before = [c.launches for c in counters]
    card = dm.ContinuousDecoder(models, penalty=-100.0, device="cuda")
    got_conf = card.predict_batch_with_confidence(clips)
    for g_utt, w_utt in zip(got_conf, want_conf):
        assert [g[:3] for g in g_utt] == [w[:3] for w in w_utt]
        assert all(abs(g[3] - w[3]) <= 1e-4 or abs(np.log(g[3]) - np.log(w[3])) <= 4e-3
                   for g, w in zip(g_utt, w_utt))
    got_nbest = card.predict_nbest(clips[0], n=3)
    assert [t for _s, t in got_nbest] == [t for _s, t in want_nbest]
    got_lat = tla.forward_lattice(card.composite, clips[0], posteriors=True, device=dev)
    assert [(a.start, a.end, a.label) for a in got_lat.sorted_arcs()] == \
        [(a.start, a.end, a.label) for a in want_lat.sorted_arcs()]
    rose = [c.launches - b_ for c, b_ in zip(counters, before)]
    assert rose[0] >= 2 and rose[1] == 1 and rose[2] == 1, rose


# -- FBD, the dense forward-backward (csrc/forward_backward.cu) ---------------

FBD_CASES = {  # name -> (S, T, B, matrix, pinned final)
    "word-S5": (5, 128, 64, "uniform", False),
    "word-S5-banded-final": (5, 40, 16, "banded", True),
    "S1": (1, 9, 4, "uniform", True),
    "S2-T1": (2, 1, 5, "uniform", False),
    "sentence-S59": (59, 70, 8, "banded", True),
    "S128": (128, 33, 3, "uniform", True),
    "dead-column": (9, 30, 6, "dead", False),
    # Every build of the plan at its bucket's edges; a warp of w8 / w16
    # holds 4 / 2 sequences, rows 0-3 of lengths T, 1, 0 and T + 3.
    "S8-learned": (8, 50, 11, "learned", False),
    "S8-banded-final": (8, 45, 9, "banded", True),
    "S9-learned": (9, 40, 7, "learned", False),
    "S16-banded-final": (16, 60, 6, "banded", True),
    "S17-uniform": (17, 30, 5, "uniform", False),
    "S32-learned": (32, 50, 4, "learned", False),
    "S33-banded-final": (33, 64, 5, "banded", True),
    "S64-learned": (64, 40, 3, "learned", False),
    "S65-banded-final": (65, 80, 3, "banded", True),
    "S128-learned": (128, 24, 2, "learned", False),
    # Long rows: the emission rows loaded ahead turn over many times.
    "S5-long": (5, 700, 9, "learned", False),
    "S59-long": (59, 500, 3, "banded", True),
}
def _learned_log_a(rng, s):
    """A log_a like a trained one's: random rows with scattered -inf
    entries, a self-loop on each state, and (from 3 states) a whole -inf
    column and a whole -inf row."""
    a = rng.uniform(0.05, 1.0, size=(s, s))
    a[rng.random((s, s)) < 0.5] = 0.0
    np.fill_diagonal(a, rng.uniform(0.2, 1.0, size=s))
    if s >= 3:
        a[:, s // 2] = 0.0
        a[s // 3, :] = 0.0
    rows = a.sum(axis=1, keepdims=True)
    probs = np.divide(a, rows, out=np.zeros_like(a), where=rows > 0)
    with np.errstate(divide="ignore"):
        return np.log(probs).astype(np.float32)


def _fbd_case(dev, name, seed=0):
    """Seeded inputs of an FBD case on the card: lengths of 0, 1, past T
    and ragged (row 0 the full T); a pinned final at the last state where
    the case says, which the short rows cannot reach (ll = -inf); a learned
    matrix starts anywhere (log_init zeros)."""
    s, t, b, kind, pinned = FBD_CASES[name]
    rng = np.random.default_rng(seed)
    log_a = uniform_forward_log_a(s)
    if kind == "banded":
        from cs304_tpu_torch.ops.viterbi import banded_transition_matrix

        log_a = banded_transition_matrix(torch.as_tensor(log_a)).numpy()
    if kind == "dead":
        log_a[:, 3] = -np.inf
    if kind == "learned":
        log_a = _learned_log_a(rng, s)
    log_b = (rng.normal(size=(b, t, s)) * 3).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    lengths[1::4] = 1
    lengths[2::5] = 0
    lengths[3::6] = t + 3
    log_init = np.full(s, -np.inf, np.float32)
    log_init[0] = 0.0
    if kind == "learned":
        log_init[:] = 0.0
    final = None
    if pinned:
        final = np.full(s, -np.inf, np.float32)
        final[-1] = 0.0
        final = torch.as_tensor(final, device=dev)
    return (torch.as_tensor(log_b, device=dev), torch.as_tensor(np.ascontiguousarray(log_a),
                                                                device=dev),
            torch.as_tensor(log_init, device=dev), torch.as_tensor(lengths, device=dev), final)


def _same_bits(got, want):
    """NaN in the same cells, every other cell bitwise (signs of zero too)."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and bool(
        torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))




@pytest.mark.parametrize("mode", ["forward", "backward", "posteriors"])
@pytest.mark.parametrize("name", sorted(FBD_CASES))
def test_fb_dense_is_bitwise_plain(dev, name, mode):
    """Every output bitwise the plain version, signs of zero included (xi
    sums of subnormal terms too: the kernel's adds are __fadd_rn)."""
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd

    args = _fbd_case(dev, name)
    before = fbd.fb_dense.launches
    runs = kernel_runs(fbd.fb_dense, *args, mode=mode)
    torch.cuda.synchronize()
    assert fbd.fb_dense.launches == before + 2  # one launch a poison
    want = plain_run(fbd.fb_dense_plain, *args, mode=mode)
    want = want if isinstance(want, tuple) else (want,)
    for got in runs:
        got = got if isinstance(got, tuple) else (got,)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and _same_bits(g, w), (name, mode, i)
        if mode != "backward":
            ll = got[-1]
            assert bool(torch.isfinite(ll[0])) and not bool(torch.isnan(ll).any())


def test_fb_dense_plan_is_the_kernels(dev):
    """The library's plan and build shapes are fb_dense_plan's and
    FBD_BUILDS' (the plan picks S's bucket from 1 to 128 states)."""
    import ctypes

    from cs304_tpu_torch.ops.cuda import forward_backward as fbd

    lib = _build.load()
    names = list(fbd.FBD_BUILDS)
    assert [names[lib.cs304_fb_dense_plan(s)] for s in range(1, 129)] == \
        [fbd.fb_dense_plan(s) for s in range(1, 129)]
    assert lib.cs304_fb_dense_plan(0) == lib.cs304_fb_dense_plan(129) == -1
    shape = (ctypes.c_int * 3)()
    for k, name in enumerate(names):
        assert lib.cs304_fb_dense_build_shape(k, shape) == len(names)
        assert tuple(shape) == fbd.FBD_BUILDS[name], name


def test_fb_dense_rejects_what_the_kernel_does_not_take(dev):
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd

    log_b, log_a, log_init, lengths, _final = _fbd_case(dev, "word-S5")
    with pytest.raises(ValueError, match="states"):
        big = torch.zeros((1, 4, 129), device=dev)
        fbd.fb_dense(big, torch.zeros((129, 129), device=dev), torch.zeros(129, device=dev),
                     lengths[:1])
    with pytest.raises(TypeError):
        fbd.fb_dense(log_b, log_a, log_init, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        fbd.fb_dense(log_b, log_a.t(), log_init, lengths)


def test_forward_backward_ops_launch_fb_dense_once(dev, monkeypatch):
    """forward, backward, forward_backward and forward_log_likelihood on
    CUDA tensors: one FBD launch each, no plain version, the plain
    version's bits (single and batched forms)."""
    from cs304_tpu_torch.ops import forward_backward as ops
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd

    log_b, log_a, log_init, lengths, final = _fbd_case(dev, "word-S5-banded-final")

    def run_ops():
        return (ops.forward(log_b, log_a, log_init, lengths, final),
                ops.backward(log_b, log_a, lengths, final),
                ops.forward_backward(log_b, log_a, log_init, lengths, final),
                ops.forward_log_likelihood(log_b[0], log_a, log_init, 17))

    with monkeypatch.context() as m:  # the plain version on the same CUDA tensors
        m.setattr(ops, "fb_dense", fbd.fb_dense_plain)
        want = plain_run(run_ops)

    def plain_on_card(*args, **kwargs):
        raise AssertionError("the plain forward-backward ran on the card")

    before = fbd.fb_dense.launches
    monkeypatch.setattr(fbd, "fb_dense_plain", plain_on_card)
    runs = kernel_runs(run_ops)
    torch.cuda.synchronize()
    assert fbd.fb_dense.launches == before + 2 * 4  # one launch a poison
    for (alpha, ll), beta, (gamma, xi, ll_p), ll_1 in runs:
        bits = [(alpha, want[0][0]), (ll, want[0][1]), (beta, want[1]), (gamma, want[2][0]),
                (xi, want[2][1]), (ll_p, want[2][2]), (ll_1, want[3])]
        assert all(_same_bits(g, w) for g, w in bits)


def test_word_baum_welch_launches_fb_dense_once_an_iteration(dev, monkeypatch):
    from cs304_tpu_torch.models import gmm_hmm as tg
    from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig
    from cs304_tpu_torch.ops.cuda import forward_backward as fbd

    rng = np.random.default_rng(9)
    centers = rng.normal(size=(5, 6)).astype(np.float32) * 4
    clips = [np.concatenate([c + rng.normal(0, 0.6, size=(int(rng.integers(3, 7)), 6))
                             for c in centers]).astype(np.float32) for _ in range(12)]
    cfg = SegmentalKMeansConfig(num_states=5, max_iterations=3, length_multiple=16,
                                cov_reg=0.01)
    log_a = np.full((5, 5), -np.inf, np.float32)
    for i in range(5):
        log_a[i, i: i + 2] = np.log(0.5) if i < 4 else 0.0
    init = tg.GMMWordHMM("w", np.stack([centers, centers + 0.3], axis=1),
                         np.tile(np.eye(6, dtype=np.float32), (5, 2, 1, 1)),
                         np.full((5, 2), 0.5, np.float32), log_a)
    calls = []
    orig = tg._bw_stats

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(tg, "_bw_stats", counted)
    monkeypatch.setattr(fbd, "fb_dense_plain", lambda *a, **k: pytest.fail("plain FB on card"))
    before = fbd.fb_dense.launches
    model = tg.train_gmm_hmm_baum_welch("w", clips, 2, cfg, init=init, device=dev)
    torch.cuda.synchronize()
    assert fbd.fb_dense.launches - before == len(calls) >= 1
    assert np.isfinite(model.means).all()
    before = fbd.fb_dense.launches
    assert np.isfinite(model.forward_score(clips[0], device=dev))
    assert fbd.fb_dense.launches == before + 1


def test_seeded_k3_is_bitwise_plain(dev):
    rng = np.random.default_rng(12)
    b, t, s = 40, 70, 9
    log_b = (rng.normal(size=(b, t, s)) * 2).astype(np.float32)
    c = [rng.normal(size=(b, s)).astype(np.float32) for _ in range(3)]
    c[1][:, 0] = c[2][:, :2] = -np.inf
    c[2][::3] = -np.inf  # skip 1 rows
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    seed = np.where(rng.random(b) < 0.5, rng.normal(size=b), 0.0).astype(np.float32)
    cpu = [torch.as_tensor(x) for x in (log_b, *c, lengths)]
    card = [x.to(dev) for x in cpu]
    for sd in (None, torch.as_tensor(seed)):
        before = tb.banded_forward.launches
        runs = kernel_runs(tb.banded_forward, *card, None if sd is None else sd.to(dev))
        torch.cuda.synchronize()
        assert tb.banded_forward.launches == before + 2  # one launch a poison
        want = plain_run(banded_sentence_forward, *cpu, sd)
        for got in runs:
            assert _same_bits(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_arc_scores_and_assoc_backtrace_card_equals_cpu(dev):
    """lattice_rescore's arc scores on the card: one K3 launch for all
    arcs, bitwise the CPU's; the rescored path equal. The associative
    decode's backtrace: one K2-bt launch, path and score equal to the CPU's."""
    from cs304_tpu_torch.ops import rescore as tr
    from cs304_tpu_torch.ops.viterbi_assoc import viterbi_composite_assoc

    comp = flagship_composite()
    clip = _sampled_clips(1, 21)[0][:24]
    log_b = comp.log_likelihoods(clip, device="cpu")
    lat = tr.exhaustive_lattice(comp, len(clip))
    want = plain_run(tr.arc_acoustic_scores, comp, lat.arcs, log_b=log_b, device="cpu")
    before = tb.banded_forward.launches
    runs = kernel_runs(tr.arc_acoustic_scores, comp, lat.arcs, log_b=log_b.to(dev), device=dev)
    assert tb.banded_forward.launches == before + 2  # one launch a poison
    for got in runs:
        np.testing.assert_array_equal(got, want)
    assert tr.lattice_rescore(comp, lat, log_b=log_b.to(dev), device=dev)[:2] == \
        tr.lattice_rescore(comp, lat, log_b=log_b, device="cpu")[:2]
    with pytest.raises(ValueError, match="skip"):
        tr.arc_acoustic_scores(comp, lat.arcs[:3], log_b=log_b.to(dev), skip=3, device=dev)
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit, comp.penalty)
    w_s, w_p = plain_run(viterbi_composite_assoc, log_b, *topo)
    before = tsf.trellis_backtrace.launches
    runs = kernel_runs(viterbi_composite_assoc, log_b.to(dev), *topo)
    assert tsf.trellis_backtrace.launches == before + 2  # one launch a poison
    for g_s, g_p in runs:
        assert float(g_s) == float(w_s) and torch.equal(g_p.cpu(), w_p)
