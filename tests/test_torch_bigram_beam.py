"""Search on the port's composite trellis against the JAX package on the
CPU: the bigram LM's per-pair entry update and the beam
(ops/viterbi.viterbi_composite_batch_fast(pair_penalty=, beam=), the plain
version of the LM and BEAM decode modes of the scan-free team kernel)
bitwise the JAX banded step, with exact ties, equal and zero pair values,
single-state words, unreachable exits, tight and infinite beams and both
together; the LM mode's codes (one source state a step and word) walked
into the same paths; the dense "scan" trellis on the (S, S) pair matrix;
and ContinuousDecoder(bigram=, lm_weight=, beam=) on every backend with
device="cpu", GMMs included, and predict_signal_batch with a bigram, against
the JAX decoder. Trellis scores and paths are bitwise given the same log_b;
decoder scores (emissions computed by each package) within rtol 1e-6, paths
and transcripts equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu.ops import lm as jlm
from cs304_tpu.ops.viterbi import entry_update as j_entry_update
from cs304_tpu.ops.viterbi import viterbi_composite_batch as j_dense
from cs304_tpu_torch.data.batching import make_signals
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import flagship_composite, flagship_models
from cs304_tpu_torch.ops import lm as tlm
from cs304_tpu_torch.ops import viterbi as tv
from cs304_tpu_torch.ops.cuda import trellis_scanfree as tsf
from test_torch_decoder import _jax_models, _sampled_features
from test_torch_gmm_decode import _gmm_models, _to_jax
from test_torch_viterbi import _composite, _topology, j_fast
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _pair(comp, mode, seed=0):
    """(W, W) pair penalties: "random" (a trained-like spread), "ties" (all
    equal), "zero" (exact zeros in some rows and columns)."""
    w = len(comp.labels)
    rng = np.random.default_rng(seed)
    if mode == "ties":
        return np.full((w, w), np.float32(-4.0))
    pair = (rng.normal(size=(w, w)) * 4 - 20).astype(np.float32)
    if mode == "zero":
        pair[:, 0] = 0.0
        pair[1] = 0.0
    return pair


def _both(log_b, lengths, comp, pair, beam, quirk=True):
    """(JAX fast, port plain) (scores, paths) on the same inputs."""
    log_a, lower, entry, exit_, pen = _topology(comp)
    want = j_fast(jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lower),
                  jnp.asarray(entry), jnp.asarray(exit_), jnp.float32(pen),
                  jnp.asarray(lengths), quirk_backtrace=quirk,
                  pair_penalty=None if pair is None else jnp.asarray(pair),
                  word_of_state=jnp.asarray(comp.word_of_state),
                  uppers=jnp.asarray(comp.uppers),
                  beam=None if beam is None else jnp.float32(beam))
    got = tv.viterbi_composite_batch_fast(
        torch.as_tensor(log_b), log_a, lower, entry, exit_, float(pen),
        torch.as_tensor(lengths), quirk_backtrace=quirk, pair_penalty=pair,
        word_of_state=comp.word_of_state, uppers=comp.uppers, beam=beam)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


# words, states per word, pair mode (None: flat penalty), beam, integer log_b
CASES = {
    "lm": (6, (5, 3), "random", None, False),
    "lm-ties": (6, (5, 3), "ties", None, True),
    "lm-zero": (6, (5, 3), "zero", None, False),
    "lm-single-state-words": (5, (1, 3), "random", None, True),
    "lm-flagship-shape": (12, (5, 5, 3), "random", None, False),
    "beam-tight": (4, (5,), None, 3.0, False),
    "beam-inf": (4, (5,), None, float("inf"), False),
    "beam-ties": (6, (5, 3), None, 2.0, True),
    "lm-beam": (12, (5, 5, 3), "random", 8.0, False),
    "lm-beam-wide": (30, (5, 5, 3), "zero", 50.0, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_search_is_bitwise_jax(case):
    words, spw, mode, beam, ties = CASES[case]
    comp = _composite(words, spw)
    rng = np.random.default_rng(len(case))
    shape = (12, 30, comp.num_states)
    log_b = (rng.integers(-3, 1, shape) if ties else rng.normal(size=shape) * 3)
    log_b = log_b.astype(np.float32)
    lengths = rng.integers(1, 31, size=12).astype(np.int32)
    lengths[0] = 30
    pair = _pair(comp, mode) if mode else None
    (ws, wp), (gs, gp) = _both(log_b, lengths, comp, pair, beam)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gp, wp)
    assert np.isfinite(ws).mean() >= 0.5
    if beam is None or beam > 10:
        return
    # A narrow beam prunes states the unpruned trellis keeps.
    coefs = tv.pack_coefs(*_topology(comp)[:4])
    lm = tv.lm_tables(pair, comp.word_of_state, comp.uppers) if mode else None
    dead = [int((~torch.isfinite(tv.forward_fast(torch.as_tensor(log_b), coefs,
                                                 comp.penalty, torch.as_tensor(lengths),
                                                 lm=lm, beam=b_)[0])).sum())
            for b_ in (None, beam)]
    assert dead[1] > dead[0]


def test_entry_update_matches_jax_with_unreachable_exits():
    comp = _composite(5, (5, 3))
    rng = np.random.default_rng(3)
    alpha = (rng.normal(size=(6, comp.num_states)) * 3).astype(np.float32)
    alpha[0] = -np.inf              # every exit -inf: source word 0
    alpha[1, comp.uppers[2]] = -np.inf
    alpha[2, comp.uppers] = 1.5     # every exit tied
    for mode in ("random", "ties", "zero"):
        pair = _pair(comp, mode)
        jc, ji = j_entry_update(jnp.asarray(alpha), jnp.asarray(comp.is_exit), 0.0,
                                jnp.asarray(pair), jnp.asarray(comp.word_of_state),
                                jnp.asarray(comp.uppers))
        lm = tv.lm_tables(pair, comp.word_of_state, comp.uppers)
        tc, ti = tv.entry_update(torch.as_tensor(alpha), None, 0.0, *lm)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti[0].numpy() == comp.uppers[0]).all()


@pytest.mark.parametrize("case", ["lm", "lm-ties", "lm-beam", "beam-tight"])
def test_search_codes_walk_into_jax_paths(case):
    """The codes the LM / BEAM modes keep (one byte a state; with the LM one
    source state a step and word), from forward_fast's backpointers,
    decode back to them and walk into JAX's paths."""
    words, spw, mode, beam, ties = CASES[case]
    comp = _composite(words, spw)
    rng = np.random.default_rng(7)
    shape = (10, 25, comp.num_states)
    log_b = (rng.integers(-3, 1, shape) if ties else rng.normal(size=shape) * 3)
    log_b = log_b.astype(np.float32)
    lengths = rng.integers(1, 26, size=10).astype(np.int32)
    pair = _pair(comp, mode) if mode else None
    (ws, wp), _ = _both(log_b, lengths, comp, pair, beam)
    coefs = tv.pack_coefs(*_topology(comp)[:4])
    lm = tv.lm_tables(pair, comp.word_of_state, comp.uppers) if mode else None
    lengths_t = torch.as_tensor(lengths)
    alpha, bp = tv.forward_fast(torch.as_tensor(log_b), coefs, comp.penalty, lengths_t,
                                lm=lm, beam=beam)
    codes, src = tv.backpointer_codes(bp, coefs, lengths_t, per_word=lm is not None)
    assert src.shape == ((10, 25, words) if lm is not None else (10, 25))
    scores, best = tv.first_max(alpha, coefs[5] > 0)
    paths = tv.backtrace_codes(codes, src, best, lengths_t,
                               word_of_state=comp.word_of_state if lm is not None else None)
    np.testing.assert_array_equal(scores.numpy(), ws)
    np.testing.assert_array_equal(paths.numpy(), wp)
    # The kernels' wrappers on CPU tensors run exactly this plain version.
    if lm is not None:
        got = tsf.scanfree_decode_lm(torch.as_tensor(log_b), coefs, lm, lengths_t, beam=beam)
    else:
        got = tsf.scanfree_decode_beam(torch.as_tensor(log_b), coefs, comp.penalty,
                                       lengths_t, beam)
    np.testing.assert_array_equal(got[1].numpy(), wp)


def test_dense_scan_with_pair_matrix_is_bitwise_jax():
    comp = flagship_composite()
    bg_args = (["12", "375", "4Z", "9O2", "186Z"], comp.labels)
    pair_t = tlm.pair_penalty_matrix(comp, tlm.train_word_bigram(*bg_args), 1.5)
    np.testing.assert_array_equal(pair_t, jlm.pair_penalty_matrix(
        comp, jlm.train_word_bigram(*bg_args), 1.5))
    rng = np.random.default_rng(4)
    log_b = (rng.normal(size=(8, 40, comp.num_states)) * 3).astype(np.float32)
    lengths = rng.integers(1, 41, size=8).astype(np.int32)
    log_a, lower, entry, exit_, _pen = _topology(comp)
    ws, wp = j_dense(jnp.asarray(log_b), jnp.asarray(log_a), jnp.asarray(lower),
                     jnp.asarray(entry), jnp.asarray(exit_), jnp.asarray(pair_t),
                     jnp.asarray(lengths))
    gs, gp = tv.viterbi_composite_batch(torch.as_tensor(log_b), log_a, lower, entry,
                                        exit_, torch.as_tensor(pair_t),
                                        torch.as_tensor(lengths))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def _bigram(mod):
    rng = np.random.default_rng(9)
    digits = list("123456789OZ")
    corpus = ["".join(rng.choice(digits, size=int(rng.integers(1, 6)))) for _ in range(80)]
    return mod.train_word_bigram(corpus, sorted(digits + ["S"]), insert_silence=True)


@pytest.mark.parametrize("search", ["bigram", "beam", "bigram+beam"])
def test_decoder_search_on_every_backend_matches_jax(search):
    kw = {"bigram": {"lm_weight": 3.0}, "beam": {"beam": 40.0},
          "bigram+beam": {"lm_weight": 3.0, "beam": 60.0}}[search]
    feats = _sampled_features(21, 4, max_words=3)
    jkw, tkw = dict(kw), dict(kw)
    if "bigram" in search:
        jkw["bigram"], tkw["bigram"] = _bigram(jlm), _bigram(tlm)
    jax_backends = ("fast", "scan") if search == "bigram" else ("fast",)
    want = {}
    for backend in jax_backends:
        jdec = JDecoder(_jax_models(), penalty=-100.0, backend=backend, **jkw)
        want[backend] = (jdec.predict_batch(feats), jdec.viterbi_batch(feats))
    for backend in ("auto", "fast", "scan", "scanfree", "pallas"):
        dec = ContinuousDecoder(flagship_models(), penalty=-100.0, backend=backend,
                                device="cpu", **tkw)
        texts, (js, jp, jl) = want["scan" if backend == "scan" and search == "bigram"
                                   else "fast"]
        # Equal paths decode to equal texts; the word epilogue once a search.
        if backend in ("auto", "scan"):
            assert dec.predict_batch(feats) == texts, backend
        ts, tp, tl = dec.viterbi_batch(feats)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(ts, js, rtol=1e-6)
        np.testing.assert_array_equal(tp, jp)
    # The search changed the scores the flat decode gives.
    flat = JDecoder(_jax_models(), penalty=-100.0).viterbi_batch(feats)[0]
    assert not np.array_equal(want["fast"][1][0], flat) or search == "beam"


def test_gmm_decoder_with_bigram_and_beam_matches_jax():
    models = _gmm_models()
    feats = _sampled_features(5, 3)
    for kw in ({"bigram": True, "lm_weight": 2.0}, {"beam": 30.0}):
        jkw, tkw = dict(kw), dict(kw)
        if "bigram" in kw:
            jkw["bigram"], tkw["bigram"] = _bigram(jlm), _bigram(tlm)
        jdec = JDecoder(_to_jax(models), penalty=-100.0, backend="fast", **jkw)
        tdec = ContinuousDecoder(models, penalty=-100.0, device="cpu", **tkw)
        assert tdec.predict_batch(feats) == jdec.predict_batch(feats)
        js, jp, _ = jdec.viterbi_batch(feats)
        ts, tp, _ = tdec.viterbi_batch(feats)
        np.testing.assert_allclose(ts, js, rtol=1e-4)
        np.testing.assert_array_equal(tp, jp)


def test_predict_signal_batch_with_bigram_matches_jax():
    sig = list(make_signals(4, 1.5, seed=3))
    want = JDecoder(_jax_models(), penalty=-100.0, bigram=_bigram(jlm),
                    lm_weight=2.0).predict_signal_batch(sig)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, bigram=_bigram(tlm),
                            lm_weight=2.0, device="cpu")
    assert dec.predict_signal_batch(sig) == want


def test_lm_weight_zero_and_penalty_setter():
    feats = _sampled_features(8, 4)
    flat = ContinuousDecoder(flagship_models(), penalty=-60.0, device="cpu")
    lm0 = ContinuousDecoder(flagship_models(), penalty=-60.0, bigram=_bigram(tlm),
                            lm_weight=0.0, device="cpu")
    assert lm0.predict_batch(feats) == flat.predict_batch(feats)
    # The pair penalties follow a new flat penalty, as JAX's per-call ones do.
    lm0.penalty = flat.penalty = -5.0
    np.testing.assert_array_equal(lm0.viterbi_batch(feats)[1], flat.viterbi_batch(feats)[1])
    with pytest.raises(ValueError, match="beam"):
        ContinuousDecoder(flagship_models(), beam=0.0, device="cpu")
