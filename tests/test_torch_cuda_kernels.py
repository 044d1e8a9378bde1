"""The port's three CUDA kernels against their plain PyTorch versions, on
the card: the quad-form emission kernel (within rtol 1e-4 / atol 1e-3, as
tests/test_pallas_emission.py holds the Pallas kernel) and the scan-free
trellis pair (scores and full paths bitwise equal, ties and T=1 included).

These are chip_smoke.py's phases 3-4 at small sizes. Every test needs a card
and skips without one; there is no CPU mode of a CUDA kernel. The machine
with the card has no JAX, so run this file without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""
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
from cs304_tpu_torch.ops.cuda import emission as em
from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
from cs304_tpu_torch.ops.gaussian import gaussian_log_pdf_quad, make_gaussian_quad_params
from cs304_tpu_torch.ops.viterbi import pack_coefs, viterbi_composite_batch_fast

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


@pytest.mark.parametrize("num_words,n,d", [(11, 1000, 39), (100, 200, 39), (1, 77, 5)])
def test_emission_kernel_matches_plain(dev, num_words, n, d):
    comp = _composite(num_words, d)
    s = comp.num_states
    s_pad = -(-s // 128) * 128
    frames = torch.randn((n, d), generator=torch.Generator().manual_seed(n)).to(dev)
    packed = em.pack_quad_params(comp.means, comp.covariances, s_pad, device=dev)
    before = em.emission.launches
    got = em.emission(frames, *packed, num_states=s, s_pad=s_pad)
    assert em.emission.launches == before + 1
    want = em.emission_plain(frames, *packed)
    torch.cuda.synchronize()
    assert got.shape == (n, s_pad)
    torch.testing.assert_close(got[:, :s], want[:, :s], rtol=1e-4, atol=1e-3)
    assert not got[:, s:].any()
    # Unpadded (s_pad == S) through gaussian_log_pdf_quad.
    qp = make_gaussian_quad_params(comp.means, comp.covariances, device=dev)
    unpadded = gaussian_log_pdf_quad(qp, frames.reshape(1, n, d))
    torch.testing.assert_close(unpadded[0], want[:, :s], rtol=1e-4, atol=1e-3)


def _trellis_case(dev, comp, log_b, lengths):
    coefs = pack_coefs(comp.log_a, comp.lower_of_state, comp.is_entry,
                       comp.is_exit, device=dev)
    before = (tsf.trellis_forward.launches, tsf.trellis_backtrace.launches)
    got = tsf.scanfree_decode(log_b, coefs, comp.penalty, lengths)
    assert (tsf.trellis_forward.launches, tsf.trellis_backtrace.launches) == (
        before[0] + 1, before[1] + 1)
    want = viterbi_composite_batch_fast(
        log_b[..., : comp.num_states].contiguous(), comp.log_a,
        comp.lower_of_state, comp.is_entry, comp.is_exit, comp.penalty, lengths)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["flagship", "503", "ties", "b5-t1", "b5-t2", "padded"])
def test_trellis_pair_is_bitwise_plain(dev, case):
    gen = torch.Generator(device=dev).manual_seed(0)
    comp = _composite(100) if case == "503" else flagship_composite()
    s = comp.num_states
    b, t = {"b5-t1": (5, 1), "b5-t2": (5, 2), "503": (8, 40)}.get(case, (33, 50))
    if case == "ties":
        log_b = torch.randint(-3, 1, (b, t, s), generator=gen, device=dev).float()
    elif case == "padded":  # the emission kernel's 128-column layout
        log_b = 3 * torch.randn((b, t, 128), generator=gen, device=dev)
    else:
        log_b = 3 * torch.randn((b, t, s), generator=gen, device=dev)
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    _trellis_case(dev, comp, log_b, lengths)


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


def test_decoder_scanfree_matches_fast_backend_on_card(dev):
    from cs304_tpu_torch.data.batching import make_signals
    from cs304_tpu_torch.models.decoder import ContinuousDecoder

    signals = list(make_signals(6, 1.5, seed=11))
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                            device="cuda")
    assert dec.backend == "scanfree"
    plain = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                              backend="fast", device="cuda")
    launches = em.emission.launches
    got = dec.predict_signal_batch(signals)
    assert em.emission.launches > launches
    assert got == plain.predict_signal_batch(signals)
