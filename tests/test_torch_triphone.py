"""The port's triphones and generalized (tied) triphones
(cs304_tpu_torch/models/triphone.py) against the JAX package's
models/triphone.py, on the CPU.

Tolerances:
  - bitwise: unit labels, the derived lexicons, observed units, clones, the
    back-off chain (triphone -> biphone -> monophone) and composed word
    models, given the same inputs;
  - bitwise: the unit clustering (cluster_triphone_units) given the same
    seed units, here JAX's MAP-smoothed seed pass;
  - trained units within rtol 1e-4 / atol 1e-5 of JAX's with the same
    iteration count (full re-estimation on tests/test_torch_lexicon.py's
    mini corpus); tie_and_train_triphones' mapping and tied lexicon equal
    JAX's and its tied models within the same tolerance.
"""
import pytest

import cs304_tpu.models.triphone as jtri
from cs304_tpu.models.train_continuous import ContinuousTrainConfig as JConfig
import cs304_tpu_torch.models.triphone as ptri
from cs304_tpu_torch.models.lexicon import Lexicon
from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig
from test_torch_biphone import trained_phones
from test_torch_lexicon import (
    ITERATIONS,
    _phone,
    assert_models_close,
    assert_models_equal,
    jax_lexicon,
    mini_corpus,
    to_jax,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def test_unit_naming_and_lexicons_match_jax():
    assert ptri.triphone_label("S", "p1", "p2") == jtri.triphone_label("S", "p1", "p2")
    assert ptri.split_triphone("p0-p1+S") == jtri.split_triphone("p0-p1+S") == ("p0", "p1", "S")
    for bad in ("p0-p1", "p0+p1", "p1"):
        with pytest.raises(ValueError):
            ptri.split_triphone(bad)
    with pytest.raises(ValueError):
        ptri.triphone_label("S", "p+1", "S")
    for phones in (("p0",), ("p0", "p1", "p0")):
        assert ptri.word_units_tri(phones) == jtri.word_units_tri(phones)
    lex = mini_corpus()[1]
    jlex = jax_lexicon(lex)
    for words in (None, lex.words[1:4]):
        assert ptri.triphone_lexicon(lex, words).entries == \
            jtri.triphone_lexicon(jlex, words).entries
        assert ptri.observed_units_tri(lex, words) == jtri.observed_units_tri(jlex, words)


def test_clones_and_backoff_chain_bitwise_jax():
    phones = {"pA": _phone("pA", 0.0), "pZ": _phone("pZ", 4.0), "S": _phone("S", -5.0)}
    units = {"S-pA+pZ", "pA-pZ+S", "pZ-pA+S"}
    tri = ptri.clone_triphone_models(phones, {"S-pA+pZ"})
    assert_models_equal(tri, jtri.clone_triphone_models(to_jax(phones), {"S-pA+pZ"}))
    bi = {"pA-pZ": _phone("pA-pZ", 7.0)}
    for bi_models in (bi, {}):
        got = ptri.backoff_table_tri(tri, bi_models, phones, units)
        want = jtri.backoff_table_tri(to_jax(tri), to_jax(bi_models), to_jax(phones), units)
        assert got[1:] == want[1:]
        assert_models_equal(got[0], want[0])
    with pytest.raises(ValueError, match="no triphone"):
        ptri.backoff_table_tri({}, {}, phones, {"pA-pQ+S"})
    lex = Lexicon({"az": ("pA", "pZ"), "za": ("pZ", "pA")})
    for bi_models in (bi, None):
        got = ptri.compose_word_models_triphone(lex, tri, phones, biphone_models=bi_models)
        want = jtri.compose_word_models_triphone(
            jax_lexicon(lex), to_jax(tri), to_jax(phones),
            biphone_models=None if bi_models is None else to_jax(bi_models))
        assert_models_equal(got, want)


def test_train_triphone_models_matches_jax():
    _c, lex, _tw, _oov, _s, _raw, labeled, _sil = mini_corpus()
    phones = trained_phones()
    got, n_got = ptri.train_triphone_models(
        phones, labeled, lex, ContinuousTrainConfig(max_iterations=ITERATIONS, cov_reg=0.1),
        device="cpu")
    want, n_want = jtri.train_triphone_models(
        to_jax(phones), labeled, jax_lexicon(lex),
        JConfig(max_iterations=ITERATIONS, cov_reg=0.1))
    assert n_got == n_want
    assert_models_close(got, want)


def test_cluster_triphone_units_bitwise_on_jax_seed_units():
    _c, lex, _tw, _oov, _s, _raw, labeled, _sil = mini_corpus()
    seed, _ = jtri.train_triphone_models(to_jax(trained_phones()), labeled, jax_lexicon(lex),
                                         smooth_tau=30.0)
    for max_per_phone in (1, 2, 3):
        assert ptri.cluster_triphone_units(seed, max_per_phone) == \
            jtri.cluster_triphone_units(seed, max_per_phone)
    with pytest.raises(ValueError, match="max_per_phone"):
        ptri.cluster_triphone_units(seed, 0)


def test_tie_and_train_triphones_matches_jax():
    _c, lex, _tw, oov, _s, _raw, labeled, _sil = mini_corpus()
    phones = trained_phones()
    cfg = dict(max_iterations=ITERATIONS, cov_reg=0.1)
    got, lex_got, map_got = ptri.tie_and_train_triphones(
        phones, labeled, lex, max_per_phone=2, config=ContinuousTrainConfig(**cfg),
        device="cpu")
    want, lex_want, map_want = jtri.tie_and_train_triphones(
        to_jax(phones), labeled, jax_lexicon(lex), max_per_phone=2, config=JConfig(**cfg))
    assert map_got == map_want
    assert lex_got.entries == lex_want.entries
    assert oov[0] in lex_got
    assert_models_close(got, want)
    with pytest.raises(TypeError, match="DeviceMesh"):  # not a data-parallel mesh
        ptri.tie_and_train_triphones(phones, labeled, lex, max_per_phone=2,
                                     config=ContinuousTrainConfig(**cfg), mesh=object(),
                                     device="cpu")
