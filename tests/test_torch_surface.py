"""The port's surface that mirrors the JAX package's, against it on the CPU
with the JAX tests' own cases: WordHMM.dim / emission_params /
log_likelihoods / predict, CompositeHMM.emission_params / viterbi /
word_state_range, sentence_hmm, MFCCConfig.feature_dim / num_frames,
GaussianParams.dim, batching.pad_signals, the single-utterance counted,
grammar and duration trellises, and the package's lazy top-level exports.

Tolerances: the trellises on the same log_b are bitwise (max-plus is adds
and compares); emission parameters and log-densities rtol 1e-5 / atol 1e-4
(each package whitens with its own float32 triangular solve), and the
scores decoded from them rtol 1e-5 with the paths equal.
"""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cs304_tpu_torch
from cs304_tpu.data import batching as jbatch
from cs304_tpu.models import hmm as jhmm
from cs304_tpu.ops import grammar as jg
from cs304_tpu.ops import mfcc as jmfcc
from cs304_tpu.ops import viterbi_counted as jvc
from cs304_tpu.ops import viterbi_duration as jvd
from cs304_tpu_torch.data import batching as tbatch
from cs304_tpu_torch.models import hmm as thmm
from cs304_tpu_torch.ops import grammar as tg
from cs304_tpu_torch.ops import mfcc as tmfcc
from cs304_tpu_torch.ops import viterbi_counted as tvc
from cs304_tpu_torch.ops import viterbi_duration as tvd
from test_torch_bigram_beam import one_torch_thread  # noqa: F401


def _word(pkg, label, s, rng, d=4, scale=3.0):
    """tests/test_viterbi_counted.py's and test_nbest.py's word model, in
    either package."""
    a = rng.normal(size=(s, d, 2)).astype(np.float32)
    return pkg.WordHMM(label=label, means=rng.normal(size=(s, d)).astype(np.float32) * scale,
                       covariances=a @ a.transpose(0, 2, 1) + np.eye(d, dtype=np.float32),
                       log_a=pkg.uniform_forward_log_a(s))


def _both(seed, spec, penalty=-2.0):
    """The same composite in both packages: spec = ((label, states), ...)."""
    out = []
    for pkg in (jhmm, thmm):
        rng = np.random.default_rng(seed)
        out.append(pkg.stack_word_models([_word(pkg, lab, s, rng) for lab, s in spec],
                                         penalty=penalty))
    return out


def _close(got, want, rtol=1e-5, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed,s,d,t,length", [(0, 5, 4, 14, None), (1, 3, 7, 20, 11),
                                               (2, 6, 39, 30, None)])
def test_word_hmm_surface_matches_jax(seed, s, d, t, length):
    rng = np.random.default_rng(seed)
    jw = _word(jhmm, "A", s, rng, d)
    tw = thmm.WordHMM(label="A", means=jw.means, covariances=jw.covariances, log_a=jw.log_a)
    feats = (rng.normal(size=(t, d)) * 2).astype(np.float32)
    assert tw.dim == jw.dim == d
    jp, tp = jw.emission_params(), tw.emission_params(device="cpu")
    for g, w in zip(tp, jp):
        _close(g.numpy(), w)
    assert tp.dim == jp.dim and tp.num_states == jp.num_states == s
    _close(tw.log_likelihoods(feats, device="cpu").numpy(), jw.log_likelihoods(feats))
    js, jpath = jw.predict(feats, length)
    ts, tpath = tw.predict(feats, length, device="cpu")
    _close(ts.item(), float(js), atol=0)
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))


@pytest.mark.parametrize("seed,spec,t", [
    (0, (("A", 3), ("B", 3)), 14),  # tests/test_nbest.py's composite
    (3, (("A", 3), ("S", 3), ("B", 3)), 25),  # tests/test_boundaries.py's layout
])
def test_composite_surface_matches_jax(seed, spec, t):
    jc, tc = _both(seed, spec)
    feats = (np.random.default_rng(seed + 10).normal(size=(t, 4)) * 2).astype(np.float32)
    for g, w in zip(tc.emission_params(device="cpu"), jc.emission_params()):
        _close(g.numpy(), w)
    _close(tc.log_likelihoods(feats, device="cpu").numpy(), jc.log_likelihoods(feats))
    js, jpath = jc.viterbi(feats)
    ts, tpath = tc.viterbi(feats, device="cpu")
    _close(ts.item(), float(js), atol=0)
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))
    assert tc.path_to_labels(tpath.numpy()) == jc.path_to_labels(np.asarray(jpath))
    for label, _s in spec:
        assert tc.word_state_range(label) == jc.word_state_range(label)
    if len(spec) == 3:  # tests/test_boundaries.py::test_word_state_range
        assert [tc.word_state_range(x) for x in "ASB"] == [(0, 3), (3, 6), (6, 9)]


@pytest.mark.parametrize("transcript", ["12", "1S21", "S3S"])
def test_sentence_hmm_matches_jax(transcript):
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    labels = ("1", "2", "3", "S")
    jm = {lab: _word(jhmm, lab, 2 if lab == "S" else 3, rng_j) for lab in labels}
    tm = {lab: _word(thmm, lab, 2 if lab == "S" else 3, rng_t) for lab in labels}
    jc, tc = jhmm.sentence_hmm(transcript, jm), thmm.sentence_hmm(transcript, tm)
    assert tc.labels == jc.labels and tc.state_counts == jc.state_counts
    np.testing.assert_array_equal(tc.log_a, jc.log_a)
    np.testing.assert_array_equal(tc.means, jc.means)
    for attr in ("lowers", "uppers", "lower_of_state", "word_of_state", "is_entry",
                 "is_exit"):
        np.testing.assert_array_equal(getattr(tc, attr), getattr(jc, attr))


@pytest.mark.parametrize("hop,n_mfcc", [(160, 13), (80, 20)])
def test_mfcc_config_surface_matches_jax(hop, n_mfcc):
    jcfg = jmfcc.MFCCConfig(hop_length=hop, n_mfcc=n_mfcc)
    tcfg = tmfcc.MFCCConfig(hop_length=hop, n_mfcc=n_mfcc)
    assert tcfg.feature_dim == jcfg.feature_dim == 3 * n_mfcc
    for n in (0, 1, 159, 160, 16000, 24000, 32001):
        assert tcfg.num_frames(n) == jcfg.num_frames(n)


@pytest.mark.parametrize("multiple", [2048, 16000])
def test_pad_signals_matches_jax(multiple):
    rng = np.random.default_rng(multiple)
    sigs = [rng.normal(size=n).astype(np.float32) for n in (100, 4097, 16000, 1)]
    got, want = tbatch.pad_signals(sigs, multiple), jbatch.pad_signals(sigs, multiple)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def _tiny_grammar_composite(seed=0, labels=("1", "2", "3", "S")):
    """tests/test_grammar.py's _tiny_composite, in the port."""
    rng = np.random.default_rng(seed)
    models = []
    for label in sorted(labels):
        s = 2 if label == "S" else 3
        models.append(thmm.WordHMM(label=label, means=rng.normal(size=(s, 4)).astype(np.float32),
                                   covariances=np.tile(np.eye(4, dtype=np.float32), (s, 1, 1)),
                                   log_a=thmm.uniform_forward_log_a(s)))
    return thmm.stack_word_models(models, penalty=-5.0)


def _topo(comp):
    return (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)


def _same(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n,n_min,t,quirk", [(0, None, 6, False), (1, None, 6, False),
                                             (2, None, 6, False), (3, None, 6, False),
                                             (2, None, 30, True), (3, 1, 30, True)])
def test_counted_single_matches_jax(n, n_min, t, quirk):
    """tests/test_viterbi_counted.py's tiny composite and counts, and
    test_grammar.py's count range."""
    rng = np.random.default_rng(0)
    comp = thmm.stack_word_models([_word(thmm, lab, 2, rng, d=3) for lab in "ABS"],
                                  penalty=-2.0)
    log_b = (rng.normal(size=(t, comp.num_states)) * 2).astype(np.float32)
    counted = comp.word_of_state != comp._silence_word
    args = (*_topo(comp), counted, np.float32(comp.penalty), n)
    want = jvc.viterbi_composite_counted(jnp.asarray(log_b), *args, quirk_backtrace=quirk,
                                         n_words_min=n_min)
    got = tvc.viterbi_composite_counted(torch.as_tensor(log_b), *args, quirk_backtrace=quirk,
                                        n_words_min=n_min)
    _same(got, want)
    if np.isfinite(float(want[0])) and n_min is None:
        assert len(comp.path_to_labels(got[1].numpy())) == n


@pytest.mark.parametrize("case", ["exact-1", "exact-2", "exact-3", "range-1-3", "strings",
                                  "positions", "none-accepted", "length"])
def test_grammar_single_matches_jax(case):
    """tests/test_grammar.py's grammars on its tiny composite."""
    comp = _tiny_grammar_composite(seed=3 if case == "strings" else 0)
    t = {"none-accepted": 6, "strings": 28}.get(case, 24)
    log_b = (np.random.default_rng(5).normal(size=(t, comp.num_states)) * 3).astype(np.float32)
    def build(pkg):
        if case.startswith("exact"):
            return pkg.WordDFA.exact_count(int(case[-1]), comp.labels)
        if case == "range-1-3":
            return pkg.WordDFA.exact_count(3, comp.labels, n_words_min=1)
        if case == "strings":
            return pkg.WordDFA.from_strings(["12", "21", "331", "2"], comp.labels)
        if case == "positions":
            return pkg.WordDFA.from_positions([("1", "2"), ("3",)], comp.labels)
        return pkg.WordDFA.exact_count(5 if case == "none-accepted" else 2, comp.labels)

    jdfa, tdfa = build(jg), build(tg)
    np.testing.assert_array_equal(tdfa.next_state, jdfa.next_state)
    np.testing.assert_array_equal(tdfa.accept, jdfa.accept)
    length = 17 if case == "length" else None
    args = (*_topo(comp), np.asarray(comp.word_of_state, np.int32))
    pen = np.float32(comp.penalty)
    want = jg.viterbi_composite_grammar(jnp.asarray(log_b), *args, jdfa.next_state,
                                        jdfa.accept, pen, length)
    got = tg.viterbi_composite_grammar(torch.as_tensor(log_b), *args, tdfa.next_state,
                                       tdfa.accept, pen, length)
    _same(got, want)
    if case == "none-accepted":
        assert np.isneginf(got[0].item())


@pytest.mark.parametrize("seed", [41, 42, 43])
@pytest.mark.parametrize("dur", [(2, jvd.UNBOUNDED), (1, 3), (2, 4)])
def test_duration_single_matches_jax(seed, dur):
    """tests/test_duration.py::test_matches_brute_force's topology and
    duration bounds."""
    rng = np.random.default_rng(seed)
    s = 5
    log_a = np.full((s, s), -np.inf, np.float32)
    base = 0
    for c in (2, 3):
        block = np.triu(rng.random((c, c)) + 0.1)
        block /= block.sum(axis=1, keepdims=True)
        with np.errstate(divide="ignore"):
            log_a[base: base + c, base: base + c] = np.log(block)
        base += c
    topo = (log_a, np.array([0, 0, 2, 2, 2], np.int32), np.array([1, 0, 1, 0, 0], bool),
            np.array([0, 1, 0, 0, 1], bool))
    t = 7
    log_b = np.round(rng.normal(size=(t, s)) * 3, 2).astype(np.float32)
    mn, mx = dur
    assert tvd.UNBOUNDED == jvd.UNBOUNDED
    min_dur, max_dur = np.full(s, mn, np.int32), np.full(s, mx, np.int32)
    d_cap = max(int(mn), int(mx) if mx < jvd.UNBOUNDED else 4, 4)
    want = jvd.viterbi_composite_duration(
        jnp.asarray(log_b), *(jnp.asarray(x) for x in topo), -4.0, jnp.asarray(min_dur),
        jnp.asarray(max_dur), t, d_cap=d_cap, quirk_backtrace=False)
    got = tvd.viterbi_composite_duration(torch.as_tensor(log_b), *topo, -4.0, min_dur, max_dur,
                                         t, d_cap=d_cap, quirk_backtrace=False)
    _same(got, want)


_JAX_EXPORTS = dict(re.findall(r'"(\w+)": "(\.[\w.]+)"', (
    Path(__file__).resolve().parents[1] / "cs304_tpu" / "__init__.py").read_text()))


def test_exports_are_the_jax_names_of_ported_modules():
    """The port exports each JAX top-level name whose module it has, from
    the same module path, and no other."""
    pkg = Path(cs304_tpu_torch.__file__).resolve().parent
    ported = {n: m for n, m in _JAX_EXPORTS.items()
              if (pkg / (m[1:].replace(".", "/") + ".py")).exists()}
    assert cs304_tpu_torch._EXPORTS == ported
    # Every JAX name: data parallelism (parallel/) is ported too.
    assert cs304_tpu_torch._EXPORTS == _JAX_EXPORTS
    # The phone tiers and the WER metrics are among them.
    assert {"Lexicon", "compose_word_models", "uniform_phone_boot", "train_phone_models",
            "train_biphone_models", "compose_word_models_biphone", "biphone_lexicon",
            "train_triphone_models", "compose_word_models_triphone", "triphone_lexicon",
            "make_word_corpus", "make_lexicon", "wer", "corpus_wer",
            "edit_ops"} <= set(cs304_tpu_torch._EXPORTS)
    assert {"fp32_exact", "resolve_device"} <= set(cs304_tpu_torch.__all__)


@pytest.mark.parametrize("name", sorted(cs304_tpu_torch._EXPORTS))
def test_export_resolves_to_its_module_object(name):
    module = importlib.import_module(cs304_tpu_torch._EXPORTS[name], "cs304_tpu_torch")
    assert getattr(cs304_tpu_torch, name) is getattr(module, name)
