"""The port's fused embedded-training iteration against cs304_tpu's
(models/train_fused.py), on a tiny well-separated corpus (3 digits + silence,
D = 6, 8 utterances, T <= 32).

Tolerances, the same inputs going through both:
  - corpus tables and the banded transition diagonals: exactly equal
    (integers, booleans and the positions of -inf);
  - one fused_viterbi_iteration: paths, counts and converged flags exactly
    equal; means within rtol 1e-5 / atol 1e-5; covariances within
    rtol 1e-4 / atol 1e-5 (XLA and torch sum in other orders); log_a within
    atol 1e-6 (and -inf at the same places).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.models import train_fused as jf
from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu.models.train_continuous import insert_silence as j_insert_silence
from cs304_tpu_torch.models import train_fused as tf
from cs304_tpu_torch.models.hmm import WordHMM, uniform_forward_log_a
from cs304_tpu_torch.models.stacking import stack_models
from cs304_tpu_torch.models.train_continuous import insert_silence

D = 6
LABELS = ("1", "2", "3", "S")


def make_models(seed=0, labels=LABELS, d=D):
    rng = np.random.default_rng(seed)
    out = {}
    for label in labels:
        s = 3 if label == "S" else 5
        means = rng.normal(size=(s, d)).astype(np.float32) * 3
        a = rng.normal(size=(s, d, 3)).astype(np.float32) * 0.2
        covs = a @ np.transpose(a, (0, 2, 1)) + 0.4 * np.eye(d, dtype=np.float32)
        out[label] = WordHMM(label=label, means=means, covariances=covs,
                             log_a=uniform_forward_log_a(s))
    return out


def make_corpus(models, transcripts, n_per, seed=1, spread=0.5):
    """Utterances walking each silence-interleaved sentence state by state
    (2-4 frames per state) around the model means."""
    r = np.random.default_rng(seed)
    labeled = {}
    for tr in transcripts:
        feats = []
        for _ in range(n_per):
            frames = []
            for w in insert_silence(tr):
                m = models[w]
                for si in range(m.num_states):
                    n = r.integers(2, 5)
                    frames.append(m.means[si] + r.normal(0, spread, size=(n, m.means.shape[1])))
            feats.append(np.concatenate(frames).astype(np.float32))
        labeled[tr] = feats
    return labeled


def jax_models(models):
    return {k: JWordHMM(label=v.label, means=v.means.copy(),
                        covariances=v.covariances.copy(), log_a=v.log_a.copy())
            for k, v in models.items()}


def _stacked(models):
    st = stack_models(models)
    return st, st.means, st.covariances, st.log_a


@pytest.fixture(scope="module")
def setup():
    models = make_models()
    labeled = make_corpus(models, ["12", "3", "21"], 3)
    st, means, covs, log_a = _stacked(models)
    slot_used = np.zeros((len(st.labels), st.s_max), bool)
    for label, i in st.label_index.items():
        slot_used[i, : st.state_counts[label]] = True
    jc = jf.prepare_fused_corpus(labeled, st.state_counts, st.label_index,
                                 j_insert_silence, 32)
    tc = tf.prepare_fused_corpus(labeled, st.state_counts, st.label_index,
                                 insert_silence, 32, device="cpu")
    return dict(st=st, means=means, covs=covs, log_a=log_a,
                slot_used=slot_used, jc=jc, tc=tc)


TABLES = ("batch", "lengths", "topo_id", "lab_tab", "loc_tab", "pos_tab",
          "samew_tab", "cross_tab", "n_states_t")


def test_prepare_fused_corpus_tables_equal(setup):
    jc, tc = setup["jc"], setup["tc"]
    for name in TABLES:
        want, got = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        assert want.dtype == got.dtype, name
        np.testing.assert_array_equal(want, got, err_msg=name)
    assert (jc.num_utts, jc.num_frames, jc.sentences) == (
        tc.num_utts, tc.num_frames, tc.sentences)
    assert tc.lengths.numpy().reshape(-1)[jc.num_utts:].tolist() == [0] * (
        tc.lengths.numel() - jc.num_utts)  # padding utterances have length 0


@pytest.mark.parametrize("cross_word", ["exit_only", "band"])
def test_sentence_trans_diagonals_equal(setup, cross_word):
    tc, log_a = setup["tc"], setup["log_a"].copy()
    log_a[1, 0, 2] = -np.inf  # a forbidden skip inside a word
    topo = tc.topo_id.reshape(-1).long()
    args = [tc.lab_tab[topo], tc.loc_tab[topo], tc.samew_tab[topo], tc.cross_tab[topo]]
    want = jf._sentence_trans_diagonals(
        jnp.asarray(log_a), *(jnp.asarray(a.numpy()) for a in args), cross_word)
    got = tf._sentence_trans_diagonals(torch.from_numpy(log_a), *args, cross_word)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _assert_params(want, got, what="", log_a_atol=1e-6):
    (wm, wc, wa), (gm, gc, ga) = want, got
    np.testing.assert_allclose(gm, wm, rtol=1e-5, atol=1e-5, err_msg=f"means {what}")
    np.testing.assert_allclose(gc, wc, rtol=1e-4, atol=1e-5, err_msg=f"covs {what}")
    np.testing.assert_array_equal(np.isfinite(wa), np.isfinite(ga), err_msg=what)
    fin = np.isfinite(wa)
    np.testing.assert_allclose(ga[fin], wa[fin], rtol=0, atol=log_a_atol,
                               err_msg=f"log_a {what}")


TIES = {
    "untied": {},
    "tied": dict(tie_flat=np.array([0, 1, 2, 3, 4, 0, 6, 7, 8, 9, 10, 11, 12, 13,
                                    14, 15, 16, 17, 18, 19], np.int32),
                 trans_tie=np.array([0, 0, 2, 3], np.int32),
                 conv_tie=np.array([0, 0, 2, 3], np.int32)),
}


@pytest.mark.parametrize("cross_word,ties", [("exit_only", "untied"),
                                             ("band", "untied"),
                                             ("exit_only", "tied")])
def test_one_fused_iteration_matches_jax(setup, cross_word, ties):
    st, jc, tc = setup["st"], setup["jc"], setup["tc"]
    kw = dict(cov_reg=0.05, rtol=1e-5, atol=1e-8, num_labels=len(st.labels),
              s_max=st.s_max, cross_word=cross_word)
    tie_kw = TIES[ties]
    params = (setup["means"], setup["covs"], setup["log_a"], setup["slot_used"])
    want = jf.fused_viterbi_iteration(
        *(jnp.asarray(p) for p in params),
        *(getattr(jc, n) for n in TABLES[3:]), jc.batch, jc.lengths, jc.topo_id,
        **kw, **{k: jnp.asarray(v) for k, v in tie_kw.items()})
    got = tf.fused_viterbi_iteration(
        *(torch.from_numpy(p) for p in params),
        *(getattr(tc, n) for n in TABLES[3:]), tc.batch, tc.lengths, tc.topo_id,
        **kw, **{k: torch.from_numpy(v) for k, v in tie_kw.items()})
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    lengths = tc.lengths.numpy()
    paths_w, paths_g = want[5], got[5]
    for k in np.ndindex(*lengths.shape):
        n = lengths[k]
        np.testing.assert_array_equal(paths_w[k][:n], paths_g[k][:n], err_msg=str(k))
    np.testing.assert_array_equal(want[3], got[3])  # counts
    np.testing.assert_array_equal(want[4], got[4])  # converged_l
    _assert_params(want[:3], got[:3], f"{cross_word}/{ties}")
    if ties == "tied":  # tied slots (label 0 state 0, label 1 state 0) agree
        np.testing.assert_array_equal(got[0][0, 0], got[0][1, 0])


@pytest.mark.parametrize("layout", ["singletons", "few_groups", "one_large_group"])
def test_pool_slots_fixed_order(layout):
    """The tie pooling over a TiePlan is bitwise a sequential scatter-add
    (each group's rows in ascending order, -0.0 starts pooled to +0.0) and
    within rtol 1e-6 / atol 1e-6 of JAX's segment sum; every row is
    gathered once whatever the group sizes."""
    rng = np.random.default_rng(7)
    n = 60
    tie = {"singletons": np.arange(n),
           "few_groups": rng.integers(0, 5, n),
           "one_large_group": np.where(rng.random(n) < 0.6, 3, np.arange(n))}[layout]
    stat = rng.normal(size=(n, 4, 4)).astype(np.float32)
    stat[::7] = -0.0
    t = torch.from_numpy(tie)
    want = torch.zeros(n, 4, 4).index_add_(0, t, torch.from_numpy(stat))[t]
    plan = tf.tie_plan(tie)
    got = tf._pool_slots(torch.from_numpy(stat), plan)
    assert torch.equal(got, want) and torch.equal(got.signbit(), want.signbit())
    assert sorted(torch.cat(plan.members).tolist()) == list(range(n))
    assert [len(m) for m in plan.members] == sorted((len(m) for m in plan.members),
                                                    reverse=True)
    jax_pooled = np.asarray(jf._pool_slots(jnp.asarray(stat), jnp.asarray(tie, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), jax_pooled, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("form", ["whiten", "quad"])
def test_gather_sentence_emissions_match_jax(setup, form):
    """Whitening within rtol 1e-5 / atol 1e-4 (float32 sum order); the
    quadratic form (a one-pass expansion) within atol 1e-3."""
    st, jc, tc = setup["st"], setup["jc"], setup["tc"]
    want = jf._gather_sentence_emissions(
        jnp.asarray(setup["means"]), jnp.asarray(setup["covs"]), jc.lab_tab,
        jc.loc_tab, jc.batch, jc.topo_id, st.s_max, form=form)
    got = tf._gather_sentence_emissions(
        torch.from_numpy(setup["means"]), torch.from_numpy(setup["covs"]),
        tc.lab_tab, tc.loc_tab, tc.batch, tc.topo_id, st.s_max, form=form)
    tol = dict(rtol=1e-5, atol=1e-4) if form == "whiten" else dict(rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_fused_train_run_matches_jax(setup):
    st, jc, tc = setup["st"], setup["jc"], setup["tc"]
    kw = dict(cov_reg=0.05, rtol=1e-5, atol=1e-8, num_labels=len(st.labels),
              s_max=st.s_max, cross_word="exit_only", max_iterations=3)
    params = (setup["means"], setup["covs"], setup["log_a"], setup["slot_used"])
    want = jf.fused_train_run(
        *(jnp.asarray(p) for p in params),
        *(getattr(jc, n) for n in TABLES[3:]), jc.batch, jc.lengths, jc.topo_id, **kw)
    got = tf.fused_train_run(
        *(torch.from_numpy(p) for p in params),
        *(getattr(tc, n) for n in TABLES[3:]), tc.batch, tc.lengths, tc.topo_id, **kw)
    assert got[4:] == (int(want[4]), bool(want[5]))  # iterations, converged
    np.testing.assert_array_equal(np.asarray(want[3]), got[3].numpy())  # counts
    _assert_params([np.asarray(w) for w in want[:3]], [g.numpy() for g in got[:3]])
    # update="baum_welch" runs (it raised before it was ported;
    # test_torch_train_bw.py holds it against JAX); an unknown update raises.
    bw = tf.fused_train_run(
        *(torch.from_numpy(p) for p in params),
        *(getattr(tc, n) for n in TABLES[3:]), tc.batch, tc.lengths, tc.topo_id,
        **dict(kw, max_iterations=1), update="baum_welch")
    assert bw[4] == 1 and all(torch.isfinite(x).all() for x in bw[:2])
    with pytest.raises(ValueError, match="update"):
        tf.fused_train_run(
            *(torch.from_numpy(p) for p in params),
            *(getattr(tc, n) for n in TABLES[3:]), tc.batch, tc.lengths, tc.topo_id,
            **kw, update="map")


@pytest.mark.parametrize("cross_word", ["exit_only", "band"])
def test_stacked_sentence_matches_jax(cross_word):
    from cs304_tpu.models.stacking import stack_models as j_stack_models

    models = make_models(seed=6)
    want = j_stack_models(jax_models(models), require_silence=True)
    got = stack_models(models, require_silence=True)
    for name in ("means", "covariances", "log_a"):
        np.testing.assert_array_equal(getattr(want, name), getattr(got, name))
    assert (want.labels, want.state_counts, want.s_max, want.dim) == (
        got.labels, got.state_counts, got.s_max, got.dim)
    w = want.sentence_for("312", True, cross_word)
    g = got.sentence_for("312", True, cross_word)
    assert w[0] == g[0] == "S3S1S2S"
    for name in ("lab_of_state", "loc_of_state", "pos_of_state"):
        np.testing.assert_array_equal(getattr(w[1], name), getattr(g[1], name))
    for a, b in zip((w[2], *w[3]), (g[2], *g[3])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        got.sentence_for("39", True)
