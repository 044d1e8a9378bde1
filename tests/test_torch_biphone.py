"""The port's left-context biphones (cs304_tpu_torch/models/biphone.py)
against the JAX package's models/biphone.py, on the CPU, and the tier
checkpoints the JAX package writes loading in the port.

Tolerances:
  - bitwise: unit labels, the derived lexicons, observed units, monophone
    clones, back-off tables, the silence preference and composed word
    models, given the same inputs;
  - trained units (full re-estimation on tests/test_torch_lexicon.py's mini
    corpus) within rtol 1e-4 / atol 1e-5 of JAX's with the same iteration
    count; the MAP-smoothed units (one map_adapt pass) the same;
  - a tier tree saved by the JAX package (save_models(..., tier=...), its
    Lexicon.save and SenoneTying.save: monophones, biphones, triphones over
    biphones, senones, tied triphones, and a manifest-less biphones/
    directory) loads through the port's load_unit_table and
    compose_from_checkpoint into tables, composed models and descriptions
    bitwise JAX's.
"""
import functools
import os

import numpy as np
import pytest

import cs304_tpu.models.biphone as jbi
from cs304_tpu.models.senone import SenoneTying as JSenoneTying
from cs304_tpu.models.train_continuous import ContinuousTrainConfig as JConfig
from cs304_tpu.utils import checkpoint as jck
import cs304_tpu_torch.models.biphone as pbi
from cs304_tpu_torch.models import lexicon as plx
from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig
from cs304_tpu_torch.utils import checkpoint as pck
from test_torch_lexicon import (
    ITERATIONS,
    _gmm_phone,
    _phone,
    assert_models_close,
    assert_models_equal,
    boot_models,
    jax_lexicon,
    mini_corpus,
    to_jax,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@functools.lru_cache(maxsize=1)
def trained_phones():
    """The port's phone tier on the mini corpus: the monophones every unit
    tier starts from."""
    _c, lex, _tw, _oov, _s, _raw, labeled, _sil = mini_corpus()
    phones, _ = plx.train_phone_models(
        boot_models(), labeled, lex,
        ContinuousTrainConfig(max_iterations=ITERATIONS, cov_reg=0.1), device="cpu")
    return phones


def test_unit_naming_and_lexicons_match_jax():
    assert pbi.biphone_label("S", "p1") == jbi.biphone_label("S", "p1") == "S-p1"
    assert pbi.split_biphone("p0-p1") == jbi.split_biphone("p0-p1")
    for bad in (lambda m: m.biphone_label("p0", "p-1"), lambda m: m.split_biphone("p1")):
        with pytest.raises(ValueError):
            bad(pbi)
    assert pbi.word_units(("p0", "p1", "p0")) == jbi.word_units(("p0", "p1", "p0"))
    lex = mini_corpus()[1]
    jlex = jax_lexicon(lex)
    for words in (None, lex.words[:3]):
        assert pbi.biphone_lexicon(lex, words).entries == jbi.biphone_lexicon(jlex, words).entries
        assert pbi.observed_units(lex, words) == jbi.observed_units(jlex, words)


def test_clones_backoff_and_silence_bitwise_jax():
    phones = {"p0": _phone("p0", 0.0), "p1": _phone("p1", 5.0), "S": _phone("S", -5.0)}
    units = {"S-p0", "p0-p1", "p1-p1"}
    clones = pbi.clone_biphone_models(phones, units)
    assert_models_equal(clones, jbi.clone_biphone_models(to_jax(phones), units))
    assert clones["p0-p1"].means is not phones["p1"].means
    with pytest.raises(ValueError, match="untrained phone"):
        pbi.clone_biphone_models(phones, {"p0-p9"})
    with pytest.raises(ValueError, match="K=1 monophones"):
        pbi.clone_biphone_models({"p0": _gmm_phone("p0", 0.0)}, {"S-p0"})
    trained = {"S-p0": clones["S-p0"]}
    got, n_got = pbi.backoff_table(trained, phones, units)
    want, n_want = jbi.backoff_table(to_jax(trained), to_jax(phones), units)
    assert n_got == n_want == 2
    assert_models_equal(got, want)
    with pytest.raises(ValueError, match="back off"):
        pbi.backoff_table({}, phones, {"S-p9"})
    table = {}
    pbi.prefer_silence(table, None, {}, {"S": phones["S"]}, phones)
    assert table["S"] is phones["S"]


def test_train_biphone_models_matches_jax():
    _c, lex, _tw, _oov, _s, _raw, labeled, _sil = mini_corpus()
    phones = trained_phones()
    got, n_got = pbi.train_biphone_models(
        phones, labeled, lex, ContinuousTrainConfig(max_iterations=ITERATIONS, cov_reg=0.1),
        device="cpu")
    want, n_want = jbi.train_biphone_models(
        to_jax(phones), labeled, jax_lexicon(lex),
        JConfig(max_iterations=ITERATIONS, cov_reg=0.1))
    assert n_got == n_want
    assert_models_close(got, want)
    composed = pbi.compose_word_models_biphone(lex, got, phones)
    assert_models_equal(composed, jbi.compose_word_models_biphone(
        jax_lexicon(lex), to_jax(got), to_jax(phones)))


def test_map_smoothed_biphones_match_jax():
    _c, lex, _tw, _oov, _s, _raw, labeled, _sil = mini_corpus()
    phones = trained_phones()
    got, n_got = pbi.train_biphone_models(phones, labeled, lex, smooth_tau=30.0, device="cpu")
    want, n_want = jbi.train_biphone_models(to_jax(phones), labeled, jax_lexicon(lex),
                                            smooth_tau=30.0)
    assert n_got == n_want == 1
    assert_models_close(got, want)
    with pytest.raises(ValueError, match="K=1 MAP pass"):
        pbi.train_biphone_models(phones, labeled, lex, smooth_tau=30.0, gmm_mixtures=2,
                                 device="cpu")


def test_train_biphone_models_validates():
    phones = {"p0": _phone("p0", 0.0), "S": _phone("S", -5.0)}
    lex = plx.Lexicon({"aa": ("p0",)})
    feats = [np.zeros((20, 3), np.float32)]
    with pytest.raises(ValueError, match="missing from lexicon"):
        pbi.train_biphone_models(phones, {("zz",): feats}, lex, device="cpu")
    with pytest.raises(ValueError, match="silence model"):
        pbi.train_biphone_models({"p0": phones["p0"]}, {("aa",): feats}, lex, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):  # not a data-parallel mesh
        pbi.train_biphone_models(phones, {("aa",): feats}, lex, mesh=object(), device="cpu")


@functools.lru_cache(maxsize=1)
def trained_tiers():
    """Every unit tier the port trains on the mini corpus (one iteration
    each): what a JAX-written checkpoint tree holds below."""
    from cs304_tpu_torch.models import senone as psn
    from cs304_tpu_torch.models import triphone as ptri

    _c, lex, _tw, _oov, _s, _raw, labeled, _sil = mini_corpus()
    phones = trained_phones()
    cfg = ContinuousTrainConfig(max_iterations=1, cov_reg=0.1)
    bi, _ = pbi.train_biphone_models(phones, labeled, lex, cfg, device="cpu")
    tri, _ = ptri.train_triphone_models(phones, labeled, lex, cfg, device="cpu")
    sen, tying, _ = psn.train_senone_models(phones, labeled, lex, max_per_state=2,
                                           config=cfg, device="cpu")
    tied, tied_lex, _ = ptri.tie_and_train_triphones(phones, labeled, lex, max_per_phone=2,
                                                     config=cfg, device="cpu")
    return phones, bi, tri, sen, tying, tied, tied_lex


TREES = {  # name -> (unit directories, lexicon directory)
    "monophones": ((), ""),
    "biphones": (("biphones",), ""),
    "biphones-no-manifest": (("biphones",), ""),
    "triphones": (("biphones", "triphones"), ""),
    "senones": (("senones",), ""),
    "tied_triphones": (("tied",), "tied"),
}


def _write_jax_tree(root, name):
    """A checkpoint tree as the JAX package's train_phones.py writes it."""
    phones, bi, tri, sen, tying, tied, tied_lex = trained_tiers()
    lex = mini_corpus()[1]
    jck.save_models(to_jax(phones), root, tier="monophones")
    jax_lexicon(lex).save(os.path.join(root, "lexicon.json"))
    units = {"biphones": bi, "triphones": tri, "senones": sen, "tied": tied}
    tiers = {"tied": "tied_triphones"}
    for sub in TREES[name][0]:
        folder = os.path.join(root, sub)
        jck.save_models(to_jax(units[sub]), folder, tier=tiers.get(sub, sub))
        if sub == "senones":
            JSenoneTying(classes=tying.classes, trees=tying.trees, num_states=tying.num_states,
                         senone_of=tying.senone_of).save(
                os.path.join(folder, "senone_tying.json"))
        if sub == "tied":
            jax_lexicon(tied_lex).save(os.path.join(folder, "lexicon.json"))
    if name == "biphones-no-manifest":  # a checkpoint from before unit_tier
        os.remove(os.path.join(root, "biphones", "manifest.json"))
    return os.path.join(root, TREES[name][1], "lexicon.json")


@pytest.mark.parametrize("name", sorted(TREES))
def test_jax_tier_checkpoint_loads_bitwise(tmp_path, name):
    path = _write_jax_tree(str(tmp_path), name)
    folder = os.path.dirname(path)
    mono_p, mono_j = pck.load_models(folder), jck.load_models(folder)
    modes = ("backoff", "synthesize") if name == "senones" else ("backoff",)
    for unseen in modes:
        lex_p, ulex_p, table_p, desc_p = pbi.load_unit_table(path, mono_p, unseen)
        lex_j, ulex_j, table_j, desc_j = jbi.load_unit_table(path, mono_j, unseen)
        assert lex_p.entries == lex_j.entries and desc_p == desc_j
        assert (ulex_p is None) == (ulex_j is None) == (name in ("monophones", "tied_triphones"))
        if ulex_j is not None:
            assert ulex_p.entries == ulex_j.entries
            assert_models_equal(table_p, table_j)
    lex_p, comp_p, desc_p = pbi.compose_from_checkpoint(path, mono_p)
    lex_j, comp_j, desc_j = jbi.compose_from_checkpoint(path, mono_j)
    assert lex_p.entries == lex_j.entries and desc_p == desc_j
    assert sorted(comp_p) == sorted(lex_p.words + ["S"])
    assert_models_equal(comp_p, comp_j)
