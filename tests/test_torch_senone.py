"""The port's senones (cs304_tpu_torch/models/senone.py) against the JAX
package's models/senone.py, on the CPU.

Tolerances:
  - collect_state_stats (one alignment pass, on the port's device): the
    labels and integer occupancies exactly JAX's, means and variances within
    rtol 1e-4 / atol 1e-5 (the trainer tests' bound);
  - bitwise, given identical inputs: the phone classes, the pooled
    likelihoods and split floors, every tree (JAX's own SlotStats fed to
    both build_senone_tying), the senone map, the SenoneTying JSON file (the
    port writes JAX's bytes and reads JAX's file), classification, the
    senone table, synthesized units, both unseen modes of
    senone_unit_table and the composed word models;
  - train_senone_models on tests/test_torch_lexicon.py's mini corpus: the
    same tying and iteration count as JAX, trained units within rtol 1e-4 /
    atol 1e-5, tied slots and tied transitions bitwise shared across units;
  - the state-granularity minimal pair of tests/test_senone.py trains in
    the port to the same shared / split pattern, tied slots bitwise shared.
"""
import functools

import numpy as np
import pytest

import cs304_tpu.models.senone as jsn
from cs304_tpu.models.train_continuous import ContinuousTrainConfig as JConfig
import cs304_tpu_torch.models.senone as psn
from cs304_tpu_torch.models.lexicon import Lexicon
from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig
from test_torch_biphone import trained_phones
from test_torch_lexicon import (
    ITERATIONS,
    assert_models_close,
    assert_models_equal,
    jax_lexicon,
    mini_corpus,
    to_jax,
)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@functools.lru_cache(maxsize=1)
def seed_and_expanded():
    """JAX's MAP-smoothed triphone seed units on the mini corpus and the
    triphone-expanded transcripts: collect_state_stats' inputs."""
    from cs304_tpu.models.triphone import train_triphone_models, triphone_lexicon

    _c, lex, train_words, _oov, _s, _raw, labeled, _sil = mini_corpus()
    jlex = jax_lexicon(lex)
    seed, _ = train_triphone_models(to_jax(trained_phones()), labeled, jlex, smooth_tau=30.0)
    tlex = triphone_lexicon(jlex, sorted(train_words))
    # Every isolated word and one sentence: JAX compiles its passes once a
    # transcript shape.
    some = [tr for tr in labeled if len(tr) == 1] + [max(tr for tr in labeled if len(tr) > 1)]
    expanded = {tlex.expand_transcript(tr): labeled[tr] for tr in some}
    return seed, expanded


@functools.lru_cache(maxsize=1)
def jax_stats():
    seed, expanded = seed_and_expanded()
    return jsn.collect_state_stats(seed, expanded)


def test_collect_state_stats_matches_jax():
    seed, expanded = seed_and_expanded()
    want = jax_stats()
    got = psn.collect_state_stats(seed, expanded, device="cpu")
    assert got.labels == want.labels and got.state_counts == want.state_counts
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_allclose(got.means, want.means, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.vars, want.vars, rtol=1e-4, atol=1e-5)
    label = next(lab for lab in want.labels if lab != "S")
    for st in range(want.state_counts[label]):
        n, mu, var = got.stats_for(label, st)
        assert n == want.stats_for(label, st)[0]
        assert mu.shape == var.shape == (39,)


def test_phone_classes_and_tree_pieces_bitwise_jax():
    phones = trained_phones()
    jphones = to_jax(phones)
    assert psn.phone_classes(phones) == jsn.phone_classes(jphones)
    assert psn.phone_classes(phones, max_classes=4) == jsn.phone_classes(jphones, max_classes=4)
    stats = jax_stats()
    items = [{"unit": lab, "prev": "S", "nxt": "S", "n": float(stats.counts[i, 0]),
              "mu": stats.means[i, 0].astype(np.float64),
              "var": stats.vars[i, 0].astype(np.float64)}
             for i, lab in enumerate(stats.labels)]
    assert psn._pooled_ll(items) == jsn._pooled_ll(items)
    assert psn._pooled_ll([]) == jsn._pooled_ll([]) == (0.0, 0.0)
    for min_gain, n in ((None, 1.0), (None, 400.0), (3.5, 10.0)):
        assert psn._split_threshold(min_gain, n, 39) == jsn._split_threshold(min_gain, n, 39)


@pytest.mark.parametrize("max_per_state,min_gain,min_count", [
    (4, 0.0, 8.0), (2, None, 8.0), (3, 50.0, 2.0), (1, 0.0, 8.0)])
def test_build_senone_tying_bitwise_on_jax_stats(tmp_path, max_per_state, min_gain, min_count):
    stats = jax_stats()
    phones = trained_phones()
    got = psn.build_senone_tying(stats, phones, max_per_state, min_gain, min_count)
    want = jsn.build_senone_tying(stats, to_jax(phones), max_per_state, min_gain, min_count)
    assert got.classes == want.classes and got.trees == want.trees
    assert got.num_states == want.num_states and got.senone_of == want.senone_of
    assert got.num_senones() == want.num_senones()
    got.save(str(tmp_path / "port.json"))
    want.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    loaded = psn.SenoneTying.load(str(tmp_path / "jax.json"))
    for unit in ("S-p01+p05", "p03-p01+S", "p05-p00+S"):
        for st in range(3):
            assert loaded.classify(unit, st) == want.classify(unit, st)
    with pytest.raises(KeyError):
        loaded.classify("S-p04+S", 0)  # no tree: p04 is in no word


def test_train_senone_models_matches_jax():
    _c, lex, _tw, _oov, _s, _raw, labeled, _sil = mini_corpus()
    phones = trained_phones()
    cfg = dict(max_iterations=ITERATIONS, cov_reg=0.1)
    got, ty_got, n_got = psn.train_senone_models(
        phones, labeled, lex, max_per_state=2, config=ContinuousTrainConfig(**cfg), device="cpu")
    want, ty_want, n_want = jsn.train_senone_models(
        to_jax(phones), labeled, jax_lexicon(lex), max_per_state=2, config=JConfig(**cfg))
    assert n_got == n_want
    assert ty_got.trees == ty_want.trees and ty_got.senone_of == ty_want.senone_of
    assert_models_close(got, want)
    # Tied slots and tied transitions are bitwise shared.
    owners = {}
    for key, name in ty_got.senone_of.items():
        unit, st = key.rsplit("/", 1)
        owners.setdefault(name, []).append((unit, int(st)))
    shared = [o for o in owners.values() if len(o) > 1]
    assert shared
    for group in shared:
        (u0, s0), *rest = group
        for u, st in rest:
            np.testing.assert_array_equal(got[u].means[st], got[u0].means[s0])
            np.testing.assert_array_equal(got[u].covariances[st], got[u0].covariances[s0])
    by_phone = {}
    for unit in got:
        if unit != "S":
            by_phone.setdefault(unit.split("-")[1].split("+")[0], []).append(unit)
    for units in by_phone.values():
        for u in units[1:]:
            np.testing.assert_array_equal(got[u].log_a, got[units[0]].log_a)
    # The table, synthesis, both unseen modes and composition on these
    # units are bitwise JAX's on the same inputs (OOV word included).
    jgot, jty, jphones = to_jax(got), ty_want, to_jax(phones)
    table = psn.senone_table(got, ty_got)
    jtable = jsn.senone_table(jgot, jty)
    assert sorted(table) == sorted(jtable)
    for name in jtable:
        for a, b in zip(table[name], jtable[name]):
            np.testing.assert_array_equal(a, b)
    lex2 = lex.with_words({"zzz": ("p00", "p02", "p05")})
    jlex2 = jax_lexicon(lex2)
    for unseen in ("backoff", "synthesize"):
        tab, n_mat = psn.senone_unit_table(lex2, got, ty_got, phones, unseen=unseen)
        jtab, jn_mat = jsn.senone_unit_table(jlex2, jgot, jty, jphones, unseen=unseen)
        assert n_mat == jn_mat > 0
        assert_models_equal(tab, jtab)
        assert_models_equal(
            psn.compose_word_models_senone(lex2, got, ty_got, phones, unseen=unseen),
            jsn.compose_word_models_senone(jlex2, jgot, jty, jphones, unseen=unseen))
    unit = "p02-p00+p05"
    assert_models_equal({unit: psn.synthesize_unit(unit, ty_got, table, got, phones)},
                        {unit: jsn.synthesize_unit(unit, jty, jtable, jgot, jphones)})
    with pytest.raises(ValueError, match="unseen mode"):
        psn.senone_unit_table(lex2, got, ty_got, phones, unseen="nearest")


def _phone(label, center, dim=3, states=3):
    from cs304_tpu_torch.models.hmm import WordHMM, uniform_forward_log_a

    means = np.array([[center, st, 0.0] for st in range(states)], np.float32)
    covs = np.tile(np.eye(dim, dtype=np.float32) * 0.2, (states, 1, 1))
    return WordHMM(label=label, means=means, covariances=covs,
                   log_a=uniform_forward_log_a(states))


def test_state_level_granularity_in_the_port():
    """tests/test_senone.py's minimal pair: "xa" and "xc" share phone pX,
    whose LAST state realizes at 3 before pA and at 9 before pC. The shared
    states tie, the differing one splits, and the tied slots and
    transitions are bitwise shared."""
    rng = np.random.default_rng(0)
    lex = Lexicon({"xa": ("pX", "pA"), "xc": ("pX", "pC")})
    realized = {"xa": 3.0, "xc": 9.0}

    def utt(word, fps=4):
        frames = [[-12.0, st, 0.0] for st in range(3) for _ in range(fps)]
        for st in range(3):
            frames += [[realized[word] if st == 2 else 6.0, st, 0.0]] * fps
        frames += [[0.0, st, 0.0] for st in range(3) for _ in range(fps)]
        frames += [[-12.0, st, 0.0] for st in range(3) for _ in range(fps)]
        f = np.asarray(frames, np.float32)
        return f + rng.normal(0, 0.05, f.shape).astype(np.float32)

    labeled = {(w,): [utt(w) for _ in range(4)] for w in lex.words}
    boot = {"pX": _phone("pX", 6.0), "pA": _phone("pA", 0.0), "pC": _phone("pC", 0.0),
            "S": _phone("S", -12.0)}
    cfg = ContinuousTrainConfig(max_iterations=4, cov_reg=0.05, length_multiple=32)
    models, tying, _ = psn.train_senone_models(boot, labeled, lex, max_per_state=2,
                                               min_gain=25.0, min_count=4.0, config=cfg,
                                               device="cpu")
    so = tying.senone_of
    assert so["S-pX+pA/0"] == so["S-pX+pC/0"] and so["S-pX+pA/1"] == so["S-pX+pC/1"]
    assert so["S-pX+pA/2"] != so["S-pX+pC/2"]
    a, c = models["S-pX+pA"], models["S-pX+pC"]
    np.testing.assert_array_equal(a.means[0], c.means[0])
    np.testing.assert_array_equal(a.covariances[1], c.covariances[1])
    np.testing.assert_array_equal(a.log_a, c.log_a)
    assert abs(a.means[2, 0] - 3.0) < 0.8 and abs(c.means[2, 0] - 9.0) < 0.8
