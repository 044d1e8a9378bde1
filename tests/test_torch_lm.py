"""The port's word-bigram and trigram LM (cs304_tpu_torch.ops.lm, a NumPy
copy of the JAX package's ops/lm.py) against the JAX module: trained tables,
the per-pair trellis penalties and the (S, S) pair matrix bit for bit, LM
log-probabilities and n-best rescoring equal; and the JAX tests' properties
(tests/test_lm.py) held on the port: rows normalise, silence interleaving,
out-of-vocabulary words take the flat penalty, a strong bigram steers an
ambiguous decode through the dense trellis."""
import numpy as np
import pytest
import torch

from cs304_tpu.models.hmm import stack_word_models as j_stack
from cs304_tpu.ops import lm as jlm
from cs304_tpu_torch.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a
from cs304_tpu_torch.ops import lm as tlm
from cs304_tpu_torch.ops.viterbi import viterbi_composite
from cs304_tpu_torch.models.hmm import flagship_models
from test_torch_decoder import _jax_models
from test_torch_bigram_beam import one_torch_thread  # noqa: F401

CORPUS = ["12", "4Z", "375", "9O2", "186Z", "54321", "12", "375", "7", "OZ8"]
LABELS = sorted(list("123456789OZ") + ["S"])


@pytest.mark.parametrize("smoothing,insert_silence", [(0.5, False), (0.1, True), (2.0, True)])
def test_trained_tables_are_bitwise_jax(smoothing, insert_silence):
    for train in ("train_word_bigram", "train_word_trigram"):
        want = getattr(jlm, train)(CORPUS, LABELS, smoothing=smoothing,
                                   insert_silence=insert_silence)
        got = getattr(tlm, train)(CORPUS, LABELS, smoothing=smoothing,
                                  insert_silence=insert_silence)
        assert got.labels == want.labels
        for name in ("log_p", "log_p_init", "log_p_final"):
            if hasattr(want, name):
                assert getattr(got, name).dtype == np.float32
                np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("lm_weight,penalty", [(1.0, None), (0.0, None), (2.5, -30.0)])
def test_pair_penalties_are_bitwise_jax(lm_weight, penalty):
    # The LM lacks "S": edges touching it take the flat penalty alone.
    bg_args = (CORPUS, sorted(set(LABELS) - {"S"}))
    tcomp = stack_word_models(flagship_models(), -100.0)
    jcomp = j_stack(_jax_models(), -100.0)
    for fn in ("word_pair_penalties", "pair_penalty_matrix"):
        want = getattr(jlm, fn)(jcomp, jlm.train_word_bigram(*bg_args), lm_weight, penalty)
        got = getattr(tlm, fn)(tcomp, tlm.train_word_bigram(*bg_args), lm_weight, penalty)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    sil = tcomp.labels.index("S")
    pen = -100.0 if penalty is None else penalty
    np.testing.assert_array_equal(
        tlm.word_pair_penalties(tcomp, tlm.train_word_bigram(*bg_args), lm_weight,
                                penalty)[sil], np.float32(pen))


def test_sequence_log_prob_and_rescore_nbest_match_jax():
    hyps = [(-10.0, "12"), (-10.5, "21"), (-11.0, "375"), (-9.0, "4Z2")]
    for kind in ("train_word_bigram", "train_word_trigram"):
        jm, tm = (getattr(m, kind)(CORPUS, LABELS, smoothing=0.3) for m in (jlm, tlm))
        for text in ("12", "54321", "", "ZZ"):
            assert tm.sequence_log_prob(list(text)) == jm.sequence_log_prob(list(text))
        for w in (0.0, 1.0, 5.0):
            assert tlm.rescore_nbest(hyps, tm, w) == jlm.rescore_nbest(hyps, jm, w)
    with pytest.raises(KeyError):
        tlm.train_word_bigram(CORPUS, LABELS).sequence_log_prob(["X"])


def test_trained_bigram_is_a_distribution():
    bg = tlm.train_word_bigram(["AB", "ABA", "BA", "A"], ["A", "B"])
    for i in range(2):
        total = np.exp(bg.log_p[i]).sum() + np.exp(bg.log_p_final[i])
        assert total == pytest.approx(1.0, rel=1e-6)
    assert np.exp(bg.log_p_init).sum() == pytest.approx(1.0, rel=1e-6)
    assert bg.log_p[0, 1] > bg.log_p[0, 0]
    tg = tlm.train_word_trigram(["AB", "ABA", "BA"], ["A", "B"])
    rows = np.exp(tg.log_p).sum(axis=2) + np.exp(tg.log_p_final)
    np.testing.assert_allclose(rows, 1.0, rtol=1e-5)


def test_insert_silence_vocab():
    bg = tlm.train_word_bigram(["AB", "AA"], ["A", "B", "S"], insert_silence=True)
    i = bg.index
    assert bg.log_p[i["A"], i["S"]] > bg.log_p[i["A"], i["B"]]
    assert bg.log_p[i["S"], i["A"]] > bg.log_p[i["S"], i["B"]]
    assert bg.sequence_log_prob(list("SASAS")) > bg.sequence_log_prob(list("SBSBS"))


def test_bigram_steers_ambiguous_decode():
    """tests/test_lm.py's steering case on the port's dense trellis with the
    (S, S) pair matrix: the flat decode repeats A, the LM forbids A -> A."""
    rng = np.random.default_rng(0)
    models = []
    for label in ("A", "B"):
        a = rng.normal(size=(3, 4, 2)).astype(np.float32)
        models.append(WordHMM(label, rng.normal(size=(3, 4)).astype(np.float32) * 3,
                              a @ a.transpose(0, 2, 1) + np.eye(4, dtype=np.float32),
                              uniform_forward_log_a(3)))
    comp = stack_word_models(models, penalty=-1.0)
    t, s = 24, comp.num_states
    log_b = np.full((t, s), -5.0, np.float32)
    log_b[:, 3:6] = -2.5  # word B's states: everywhere mediocre
    for tt in range(t):
        log_b[tt, (tt // 2) % 3] = 0.0  # word A's states cycle
    log_p = np.log(np.full((2, 2), 1e-6, np.float32))
    log_p[0, 1], log_p[1, 0], log_p[1, 1] = np.log(0.999), np.log(0.5), np.log(0.5 - 1e-6)
    bg = tlm.WordBigram(labels=["A", "B"], log_p=log_p.astype(np.float32),
                        log_p_init=np.log(np.full(2, 0.5, np.float32)),
                        log_p_final=np.log(np.full(2, 1e-6, np.float32)))
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    _, flat = viterbi_composite(torch.as_tensor(log_b), *topo, -1.0)
    pair = tlm.pair_penalty_matrix(comp, bg, lm_weight=12.0, penalty=-1.0)
    _, lm_path = viterbi_composite(torch.as_tensor(log_b), *topo, torch.as_tensor(pair))
    flat_words = comp.path_to_labels(flat.numpy(), skip_silence=False)
    lm_words = comp.path_to_labels(lm_path.numpy(), skip_silence=False)
    assert any(x == y == "A" for x, y in zip(flat_words, flat_words[1:]))
    assert not any(x == y == "A" for x, y in zip(lm_words, lm_words[1:]))
