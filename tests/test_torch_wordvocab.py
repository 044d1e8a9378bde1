"""The port's generated vocabularies (cs304_tpu_torch/data/wordvocab.py)
against the JAX package's data/wordvocab.py, on the CPU.

Tolerance: bitwise everywhere. Both draw from NumPy's default_rng with the
same seeds, so labels, phone inventories, vocabularies (formant templates),
generation-truth lexicons and the synthesized audio of a word corpus (its
isolated clips and its sentences) are the same numbers; the lexicon is the
port's own Lexicon class.
"""
import numpy as np
import pytest

import cs304_tpu.data.wordvocab as jwv
import cs304_tpu_torch.data.wordvocab as pwv
from cs304_tpu_torch.models.lexicon import Lexicon


@pytest.mark.parametrize("n", [1, 17, 75, 1125])
def test_word_labels_bitwise_jax(n):
    assert pwv.word_labels(n) == jwv.word_labels(n)
    assert len(set(pwv.word_labels(n))) == n


def test_word_labels_limit():
    with pytest.raises(ValueError, match="at most 1125"):
        pwv.word_labels(1126)


@pytest.mark.parametrize("num_phones,seed", [(24, 7), (6, 7), (40, 3)])
def test_phone_inventory_bitwise_jax(num_phones, seed):
    assert pwv.make_phone_inventory(num_phones, seed) == jwv.make_phone_inventory(num_phones, seed)


@pytest.mark.parametrize("kw", [
    dict(num_words=30),
    dict(num_words=100),
    dict(num_words=6, phones_per_word=(2, 3), num_phones=6),
    dict(num_words=20, phones_per_word=(2, 3), seed=11),
])
def test_vocabulary_and_lexicon_bitwise_jax(kw):
    vocab = pwv.make_vocabulary(**kw)
    assert vocab == jwv.make_vocabulary(**kw)
    lex = pwv.make_lexicon(**kw)
    assert isinstance(lex, Lexicon)
    assert lex.entries == jwv.make_lexicon(**kw).entries
    assert sorted(vocab) == lex.words
    inventory = pwv.make_phone_inventory(kw.get("num_phones", 24), kw.get("seed", 7))
    for word, template in vocab.items():
        assert tuple(inventory[int(p[1:])] for p in lex[word]) == template


def test_vocabulary_capacity_guard():
    with pytest.raises(ValueError, match="enlarge"):
        pwv.make_vocabulary(40, phones_per_word=(1, 1), num_phones=24)
    with pytest.raises(ValueError, match="enlarge"):
        jwv.make_vocabulary(40, phones_per_word=(1, 1), num_phones=24)


@pytest.mark.parametrize("hard", [False, True])
def test_word_corpus_audio_bitwise_jax(hard):
    kw = dict(num_train_speakers=2, num_test_speakers=1, takes_per_digit=1,
              phones_per_word=(2, 3), num_phones=6, hard=hard)
    got, want = pwv.make_word_corpus(6, **kw), jwv.make_word_corpus(6, **kw)
    assert got.labels == want.labels
    for split in ("train_dataset", "test_dataset"):
        g, w = getattr(got, split), getattr(want, split)
        assert sorted(g.data) == sorted(w.data)
        for label in w.data:
            assert len(g[label]) == len(w[label])
            for a, b in zip(g[label], w[label]):
                np.testing.assert_array_equal(a, b)
    tr = tuple(got.labels[:3])
    for spk in (0, 2):
        np.testing.assert_array_equal(got.sentence_audio(tr, spk, jitter_seed=9),
                                      want.sentence_audio(tr, spk, jitter_seed=9))
