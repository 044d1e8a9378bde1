"""The port's phone tier (cs304_tpu_torch/models/lexicon.py) against the JAX
package's models/lexicon.py, on the CPU.

The shared mini corpus of the phone-tier test files (mini_corpus below): 6
generated words of 2-3 phones over a 6-phone inventory, the last held out as
OOV, 2 training speakers with one take each, 3 two-word sentences, MFCC
from the port on the CPU, and a 3-state silence from the port's k-means. The
same features go through both packages.

Tolerances:
  - bitwise: the Lexicon API, its JSON file (the port writes JAX's bytes
    and reads JAX's file), transcript expansion, composed word models (plain
    and GMM) and the flat-start boot;
  - trained phone models within rtol 1e-4 / atol 1e-5 of JAX's (-inf at the
    same places) with the same iteration count; after the K=2 GMM stage,
    whose soft responsibilities feed the K=1 stage's float difference on,
    tests/test_torch_train_gmm.py's bound for a multi-iteration GMM run:
    means rtol 1e-4 / atol 5e-5, covariances rtol 1e-3 / atol 1e-4,
    weights atol 5e-5;
  - decoded transcripts of the composed words equal JAX's.
"""
import functools

import numpy as np
import pytest

import cs304_tpu.models.lexicon as jlx
from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu.models.gmm_hmm import GMMWordHMM as JGMM
from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu.models.train_continuous import ContinuousTrainConfig as JConfig
import cs304_tpu_torch.models.lexicon as plx
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.gmm_hmm import GMMWordHMM
from cs304_tpu_torch.models.hmm import WordHMM, uniform_forward_log_a
from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig

NUM_WORDS, PHONES_PER_WORD, NUM_PHONES = 6, (2, 3), 6
ITERATIONS = 2


@functools.lru_cache(maxsize=1)
def mini_corpus():
    """(corpus, lexicon, train words, oov words, stripped clips, raw clips,
    labeled transcripts, silence model), all from the port on the CPU."""
    from cs304_tpu_torch.audio.endpointing import SignalSeparation
    from cs304_tpu_torch.data.wordvocab import make_lexicon, make_word_corpus
    from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig, train_word_hmm
    from cs304_tpu_torch.ops.mfcc import mfcc_batch

    corpus = make_word_corpus(
        NUM_WORDS, num_train_speakers=2, num_test_speakers=1, takes_per_digit=1,
        phones_per_word=PHONES_PER_WORD, num_phones=NUM_PHONES)
    lex = make_lexicon(NUM_WORDS, phones_per_word=PHONES_PER_WORD, num_phones=NUM_PHONES)
    labels = corpus.labels
    oov, train_words = labels[-1:], labels[:-1]
    sep = SignalSeparation()
    stripped = {w: mfcc_batch(sep.remove_empty_batch(corpus.train_dataset[w]), device="cpu")
                for w in train_words}
    raw = {w: mfcc_batch(corpus.train_dataset[w], device="cpu") for w in train_words}
    noises = [x for x in sep.get_all_noises() if len(x) >= 9 * sep.frame_size]
    silence = train_word_hmm(
        "S", mfcc_batch(noises, device="cpu"),
        SegmentalKMeansConfig(num_states=3, max_iterations=4, length_multiple=32),
        device="cpu").model
    labeled = {(w,): raw[w] for w in train_words}
    rng = np.random.default_rng(5)
    for k in range(3):
        tr = tuple(str(x) for x in rng.choice(train_words, size=2))
        labeled[tr] = mfcc_batch([corpus.sentence_audio(tr, spk, jitter_seed=5000 + k)
                                  for spk in range(2)], device="cpu")
    return corpus, lex, train_words, oov, stripped, raw, labeled, silence


def to_jax(models):
    """Port models -> JAX models with copies of the same arrays."""
    out = {}
    for k, m in models.items():
        if hasattr(m, "weights"):
            out[k] = JGMM(label=m.label, means=m.means.copy(), covariances=m.covariances.copy(),
                          weights=m.weights.copy(), log_a=m.log_a.copy())
        else:
            out[k] = JWordHMM(label=m.label, means=m.means.copy(),
                              covariances=m.covariances.copy(), log_a=m.log_a.copy())
    return out


def jax_lexicon(lex):
    return jlx.Lexicon(dict(lex.entries))


GMM_TOL = {"means": (1e-4, 5e-5), "covariances": (1e-3, 1e-4), "weights": (0, 5e-5),
           "log_a": (1e-4, 1e-5)}


def assert_models_close(got, want, rtol=1e-4, atol=1e-5, per_field=None):
    """Every model's arrays within rtol / atol (per_field: name -> (rtol,
    atol)), -inf at the same places, and the same model types."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert type(got[k]).__name__ == type(want[k]).__name__, k
        for name in ("means", "covariances", "log_a", "weights"):
            if not hasattr(want[k], name):
                continue
            g, w = np.asarray(getattr(got[k], name)), np.asarray(getattr(want[k], name))
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w), err_msg=f"{k} {name}")
            fin = np.isfinite(w)
            r, a = (per_field or {}).get(name, (rtol, atol))
            np.testing.assert_allclose(g[fin], w[fin], rtol=r, atol=a, err_msg=f"{k} {name}")


def assert_models_equal(got, want):
    assert_models_close(got, want, rtol=0, atol=0)


def boot_models():
    _c, lex, _tw, _oov, stripped, _raw, _lab, silence = mini_corpus()
    boot = plx.uniform_phone_boot(stripped, lex)
    boot["S"] = silence
    return boot


def _phone(label, center, dim=3, states=3):
    means = np.zeros((states, dim), np.float32)
    means[:, 0] = center
    means[:, 1] = np.arange(states)
    return WordHMM(label=label, means=means,
                   covariances=np.tile(np.eye(dim, dtype=np.float32) * 0.3, (states, 1, 1)),
                   log_a=uniform_forward_log_a(states))


def _gmm_phone(label, center, k=2):
    means = np.zeros((3, k, 3), np.float32)
    means[:, :, 0] = center
    means[:, :, 1] = np.arange(3)[:, None]
    means[:, 1, 2] = 0.5
    return GMMWordHMM(label=label, means=means,
                      covariances=np.tile(np.eye(3, dtype=np.float32) * 0.3, (3, k, 1, 1)),
                      weights=np.full((3, k), 1.0 / k, np.float32),
                      log_a=uniform_forward_log_a(3))


def test_lexicon_api_matches_jax():
    entries = {"ab": ("p0", "p1"), "cd": ("p2",), "4": ("p0",), "Z": ("p1", "p2")}
    lex, jlex = plx.Lexicon(entries), jlx.Lexicon(entries)
    assert lex.words == jlex.words and lex.phones == jlex.phones
    assert ("ab" in lex) and ("xy" not in lex)
    for tr, sil in ((("ab", "cd"), True), (("ab",), False), ("4Z", True), ("Z4", False)):
        assert lex.expand_transcript(tr, sil) == jlex.expand_transcript(tr, sil)
    bigger = lex.with_words({"xy": ["p2", "p0"]})
    assert bigger.entries == jlex.with_words({"xy": ["p2", "p0"]}).entries
    assert "xy" not in lex
    for bad in ({"word": ()}, {"S": ("p0",)}):
        with pytest.raises(ValueError):
            plx.Lexicon(bad)


def test_lexicon_json_is_jax_bytes(tmp_path):
    lex = mini_corpus()[1]
    lex.save(str(tmp_path / "port.json"))
    jax_lexicon(lex).save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert plx.Lexicon.load(str(tmp_path / "jax.json")).entries == lex.entries
    (tmp_path / "list.json").write_text("[1, 2]")
    with pytest.raises(ValueError):
        plx.Lexicon.load(str(tmp_path / "list.json"))


def test_compose_word_models_bitwise_jax():
    phones = {"p0": _phone("p0", 0.0), "p1": _phone("p1", 5.0), "S": _phone("S", -5.0)}
    lex = plx.Lexicon({"w": ("p0", "p1", "p0"), "v": ("p1",)})
    got = plx.compose_word_models(lex, phones)
    want = jlx.compose_word_models(jax_lexicon(lex), to_jax(phones))
    assert_models_equal(got, want)
    assert got["S"] is phones["S"]
    assert got["w"].log_a[2, 3] == 0.0 and np.isneginf(got["w"].log_a[2, 4])
    assert_models_equal(plx.compose_word_models(lex, phones, words=["v"]),
                        jlx.compose_word_models(jax_lexicon(lex), to_jax(phones), words=["v"]))
    with pytest.raises(ValueError, match="untrained"):
        plx.compose_word_models(plx.Lexicon({"x": ("p9",)}), phones)


def test_compose_gmm_phones_bitwise_jax():
    """A K=2 phone and a Gaussian one compose to a GMMWordHMM (the Gaussian
    lifted to one-mixture rows), as in JAX."""
    phones = {"p0": _gmm_phone("p0", 0.0), "p1": _phone("p1", 6.0)}
    lex = plx.Lexicon({"ka": ("p0", "p1"), "to": ("p1", "p0")})
    got = plx.compose_word_models(lex, phones)
    assert isinstance(got["ka"], GMMWordHMM) and got["ka"].num_mixtures == 2
    assert_models_equal(got, jlx.compose_word_models(jax_lexicon(lex), to_jax(phones)))


def test_uniform_phone_boot_bitwise_jax():
    _c, lex, _tw, _oov, stripped, *_ = mini_corpus()
    got = plx.uniform_phone_boot(stripped, lex)
    assert_models_equal(got, jlx.uniform_phone_boot(stripped, jax_lexicon(lex)))
    with pytest.raises(ValueError, match="long enough"):
        plx.uniform_phone_boot({"aa": [np.zeros((2, 2), np.float32)]},
                               plx.Lexicon({"aa": ("pA", "pB")}))


def test_train_phone_models_matches_jax_and_decodes_the_same():
    _c, lex, _tw, oov, _s, raw, labeled, _sil = mini_corpus()
    boot = boot_models()
    got, n_got = plx.train_phone_models(
        boot, labeled, lex, ContinuousTrainConfig(max_iterations=ITERATIONS, cov_reg=0.1),
        device="cpu")
    want, n_want = jlx.train_phone_models(
        to_jax(boot), labeled, jax_lexicon(lex),
        JConfig(max_iterations=ITERATIONS, cov_reg=0.1))
    assert n_got == n_want
    assert_models_close(got, want)
    # The composed words of the port's phones (OOV included) decode as JAX's
    # decoder decodes the same models.
    composed = plx.compose_word_models(lex, got)
    assert oov[0] in composed
    feats = [f for clips in raw.values() for f in clips]
    preds = ContinuousDecoder(composed, penalty=-100.0, device="cpu").predict_batch(feats)
    assert preds == JDecoder(to_jax(composed), penalty=-100.0).predict_batch(feats)


def test_train_phone_models_gmm_stage_matches_jax():
    """gmm_mixtures=2: the K=1 stage, promote_to_gmm and the embedded GMM
    trainer, within the same tolerance of JAX's."""
    _c, lex, _tw, _oov, _s, _raw, labeled, _sil = mini_corpus()
    boot = boot_models()
    cfg = dict(max_iterations=1, cov_reg=0.1)
    got, n_got = plx.train_phone_models(boot, labeled, lex, ContinuousTrainConfig(**cfg),
                                        gmm_mixtures=2, device="cpu")
    want, n_want = jlx.train_phone_models(to_jax(boot), labeled, jax_lexicon(lex),
                                          JConfig(**cfg), gmm_mixtures=2)
    assert n_got == n_want
    assert all(isinstance(m, GMMWordHMM) and m.num_mixtures == 2 for m in got.values())
    assert_models_close(got, want, per_field=GMM_TOL)
    composed = plx.compose_word_models(lex, got)
    assert_models_equal(composed, jlx.compose_word_models(jax_lexicon(lex), to_jax(got)))


def test_train_phone_models_errors():
    phones = {"p0": _phone("p0", 0.0), "S": _phone("S", -5.0)}
    lex = plx.Lexicon({"aa": ("p0",), "bb": ("p0",)})  # the same expansion
    feats = [np.zeros((20, 3), np.float32)]
    with pytest.raises(ValueError, match="same phone sequence"):
        plx.train_phone_models(phones, {("aa",): feats, ("bb",): feats}, lex, device="cpu")
    # mesh= takes a data-parallel mesh (tests/test_torch_parallel_train.py).
    with pytest.raises(TypeError, match="DeviceMesh"):
        plx.train_phone_models(phones, {("aa",): feats}, lex, mesh=object(), device="cpu")
