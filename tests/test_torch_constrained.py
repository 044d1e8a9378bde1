"""The port's constrained composite trellises against the JAX package on
the CPU, on the same log_b: the word-count trellis
(ops/viterbi_counted.py: exact counts and count ranges), the
state-duration trellis (ops/viterbi_duration.py: floors, ceilings, per-word
knobs, saturation) and the grammar trellis (ops/grammar.py: WordDFA
builders, string sets, position patterns, exact counts); scores and paths
bitwise over ragged padded batches, including utterances with no
admissible path (score -inf). Then ContinuousDecoder.predict_batch_counted
/ predict_batch_duration / predict_batch_grammar against the JAX decoder:
transcripts equal, the fallback to the unconstrained decode where JAX takes
it, GMMs included."""
import numpy as np
import pytest
import torch

from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu.ops import grammar as jg
from cs304_tpu.ops import viterbi_counted as jvc
from cs304_tpu.ops import viterbi_duration as jvd
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import CompositeHMM, flagship_models
from cs304_tpu_torch.ops import grammar as tg
from cs304_tpu_torch.ops import viterbi_counted as tvc
from cs304_tpu_torch.ops import viterbi_duration as tvd
from test_torch_decoder import _jax_models, _sampled_features
from test_torch_gmm_decode import _gmm_models, _to_jax
from test_torch_bigram_beam import one_torch_thread  # noqa: F401
from torch_poison import KERNEL_POISONS, differing_cells, plain_run, poisoned


def _random_composite(seed, labels=("1", "2", "3", "S"), states=(3, 2, 4, 2)):
    """Words with random (non-uniform) left-to-right transitions."""
    rng = np.random.default_rng(seed)
    s_total = sum(states)
    log_a = np.full((s_total, s_total), -np.inf, np.float32)
    base = 0
    for c in states:
        block = np.zeros((c, c))
        for i in range(c):
            row = rng.random(c - i) + 0.1
            block[i, i:] = row / row.sum()
        with np.errstate(divide="ignore"):
            log_a[base: base + c, base: base + c] = np.log(block)
        base += c
    d = 4
    return CompositeHMM(list(labels), list(states), rng.normal(size=(s_total, d)).astype(
        np.float32), np.tile(np.eye(d, dtype=np.float32), (s_total, 1, 1)), log_a, -3.0)


def _batch(comp, seed, lengths=(12, 7, 3, 12, 1)):
    rng = np.random.default_rng(seed)
    log_b = (rng.normal(size=(len(lengths), max(lengths), comp.num_states)) * 3)
    return log_b.astype(np.float32), np.asarray(lengths, np.int32)


def _topo(comp):
    return (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n_words,n_min", [(1, None), (2, None), (3, None), (3, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_counted_trellis_is_bitwise_jax(n_words, n_min, seed):
    comp = _random_composite(seed)
    log_b, lengths = _batch(comp, seed)
    counted = comp.word_of_state != comp.labels.index("S")
    args = (*_topo(comp), counted, np.float32(comp.penalty), n_words)
    if n_min is None:
        want = jvc.viterbi_composite_counted_batch(log_b, *args, lengths)
    else:
        import jax

        want = jax.vmap(lambda b, l: jvc.viterbi_composite_counted(
            b, *args, l, n_words_min=n_min))(log_b, lengths)
    got = tvc.viterbi_composite_counted_batch(torch.as_tensor(log_b), *args,
                                              torch.as_tensor(lengths), n_words_min=n_min)
    _assert_same(got, want)
    assert np.isfinite(np.asarray(want[0])).mean() >= 0.4
    if n_words == 3 and n_min is None:
        assert not np.isfinite(np.asarray(want[0])).all()  # some rows have no path


@pytest.mark.parametrize("min_d,max_d,sil", [(1, None, False), (2, None, False),
                                             (2, 3, False), ({"1": 3, "2": 1}, 4, True),
                                             (2, 5, True)])
@pytest.mark.parametrize("seed", [2, 3])
def test_duration_trellis_is_bitwise_jax(min_d, max_d, sil, seed):
    comp = _random_composite(seed)
    log_b, lengths = _batch(comp, seed, lengths=(16, 9, 4, 16))
    arrays = tvd.duration_arrays(comp, min_d, max_d, sil)
    want_arrays = jvd.duration_arrays(comp, min_d, max_d, sil)
    for g, w in zip(arrays, want_arrays):
        np.testing.assert_array_equal(g, w)
    min_dur, max_dur, d_cap = arrays
    args = (*_topo(comp), np.float32(comp.penalty), min_dur, max_dur)
    want = jvd.viterbi_composite_duration_batch(log_b, *args, lengths, d_cap=d_cap)
    got = tvd.viterbi_composite_duration_batch(torch.as_tensor(log_b), *args,
                                               torch.as_tensor(lengths), d_cap=d_cap)
    _assert_same(got, want)
    assert np.isfinite(np.asarray(want[0])).mean() >= 0.5


@pytest.mark.parametrize("poison", KERNEL_POISONS)
def test_constrained_trellises_on_poisoned_memory_are_bitwise_jax(poison):
    """The counted, duration and grammar plain trellises' backpointers are
    torch.empty allocations: on memory filled with a poison their scores and
    paths stay bitwise JAX's (rows with no admissible path among them), and
    equal those computed on memory filled with another pattern."""
    comp = _random_composite(1)
    log_b, lengths = _batch(comp, 1)
    counted = comp.word_of_state != comp.labels.index("S")
    pen = np.float32(comp.penalty)
    min_dur, max_dur, d_cap = tvd.duration_arrays(comp, 2, 5)
    gt, gj = (_grammars(comp.labels, m)["strings"] for m in (tg, jg))
    word_of = comp.word_of_state.astype(np.int32)
    tb_, tl = torch.as_tensor(log_b), torch.as_tensor(lengths)
    runs = {
        "counted": (lambda: tvc.viterbi_composite_counted_batch(
            tb_, *_topo(comp), counted, pen, 3, tl),
            lambda: jvc.viterbi_composite_counted_batch(
                log_b, *_topo(comp), counted, pen, 3, lengths)),
        "duration": (lambda: tvd.viterbi_composite_duration_batch(
            tb_, *_topo(comp), pen, min_dur, max_dur, tl, d_cap=d_cap),
            lambda: jvd.viterbi_composite_duration_batch(
                log_b, *_topo(comp), pen, min_dur, max_dur, lengths, d_cap=d_cap)),
        "grammar": (lambda: tg.viterbi_composite_grammar_batch(
            tb_, *_topo(comp), word_of, gt.next_state, gt.accept, comp.penalty, tl),
            lambda: jg.viterbi_composite_grammar_batch(
                log_b, *_topo(comp), word_of, gj.next_state, gj.accept, pen, lengths)),
    }
    for name, (port, jax_fn) in runs.items():
        with poisoned(poison):
            got = port()
        _assert_same(got, jax_fn())
        assert differing_cells(got, plain_run(port)) == 0, name


def test_duration_arrays_validation():
    comp = _random_composite(0)
    with pytest.raises(ValueError, match="below"):
        tvd.duration_arrays(comp, 3, 2)
    with pytest.raises(ValueError, match=">= 1"):
        tvd.duration_arrays(comp, 0)
    single = _random_composite(0, labels=("1", "S"), states=(1, 2))
    with pytest.raises(ValueError, match="single-state"):
        tvd.duration_arrays(single, 2)


def _grammars(labels, mod):
    return {
        "strings": mod.WordDFA.from_strings(["12", "213", "3"], labels),
        "positions": mod.WordDFA.from_positions([("1", "2"), ("1", "2", "3")], labels),
        "count": mod.WordDFA.exact_count(2, labels),
        "count-range": mod.WordDFA.exact_count(3, labels, n_words_min=1),
    }


@pytest.mark.parametrize("kind", ["strings", "positions", "count", "count-range"])
def test_grammar_trellis_is_bitwise_jax(kind):
    comp = _random_composite(4)
    gt, gj = _grammars(comp.labels, tg)[kind], _grammars(comp.labels, jg)[kind]
    np.testing.assert_array_equal(gt.next_state, gj.next_state)
    np.testing.assert_array_equal(gt.accept, gj.accept)
    log_b, lengths = _batch(comp, 4)
    args = (*_topo(comp), comp.word_of_state.astype(np.int32))
    want = jg.viterbi_composite_grammar_batch(log_b, *args, gj.next_state, gj.accept,
                                              np.float32(comp.penalty), lengths)
    got = tg.viterbi_composite_grammar_batch(torch.as_tensor(log_b), *args, gt.next_state,
                                             gt.accept, comp.penalty,
                                             torch.as_tensor(lengths))
    _assert_same(got, want)
    assert np.isfinite(np.asarray(want[0])).mean() >= 0.4


def test_grammar_builders_validate():
    labels = ["1", "2", "S"]
    for bad in (lambda: tg.WordDFA.from_strings([], labels),
                lambda: tg.WordDFA.from_strings(["1S"], labels),
                lambda: tg.WordDFA.from_positions([("X",)], labels),
                lambda: tg.WordDFA.from_positions([], labels)):
        with pytest.raises(ValueError):
            bad()


def test_decoder_constrained_modes_match_jax():
    feats = _sampled_features(41, 5, min_words=1, max_words=3) + [
        _sampled_features(42, 1)[0][:6]]  # too short for 3 words: falls back
    jdec = JDecoder(_jax_models(), penalty=-100.0)
    tdec = ContinuousDecoder(flagship_models(), penalty=-100.0, device="cpu")
    labels = tdec.composite.labels
    for n in (1, 3):
        assert tdec.predict_batch_counted(feats, n) == jdec.predict_batch_counted(feats, n)
    kw = {"min_duration": 2, "max_duration": {"1": 6}}
    assert tdec.predict_batch_duration(feats, **kw) == jdec.predict_batch_duration(feats, **kw)
    gt = tg.WordDFA.from_positions([("1", "2", "3"), tuple("456789OZ")], labels)
    gj = jg.WordDFA.from_positions([("1", "2", "3"), tuple("456789OZ")], labels)
    assert tdec.predict_batch_grammar(feats, gt) == jdec.predict_batch_grammar(feats, gj)
    with pytest.raises(ValueError, match="vocabulary"):
        tdec.predict_batch_grammar(feats, tg.WordDFA.from_strings(["1"], ["1", "S"]))
    # The short utterance had no 3-word path: its text is the unconstrained one.
    assert tdec.predict_batch_counted(feats[-1:], 3) == tdec.predict_batch(feats[-1:])


def test_decoder_constrained_modes_gmm_match_jax():
    models = _gmm_models()
    feats = _sampled_features(43, 3, min_words=2, max_words=3)
    jdec = JDecoder(_to_jax(models), penalty=-100.0)
    tdec = ContinuousDecoder(models, penalty=-100.0, device="cpu")
    assert tdec.predict_batch_counted(feats, 2) == jdec.predict_batch_counted(feats, 2)
    assert tdec.predict_batch_duration(feats, 2) == jdec.predict_batch_duration(feats, 2)
    g = tdec.composite.labels
    assert tdec.predict_batch_grammar(feats, tg.WordDFA.exact_count(2, g)) == \
        jdec.predict_batch_grammar(feats, jg.WordDFA.exact_count(2, g))
