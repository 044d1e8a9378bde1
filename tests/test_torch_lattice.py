"""The port's word lattices and posteriors (cs304_tpu_torch.ops.lattice)
against the JAX package's ops/lattice.py on the CPU, on the same log_b:
word spans, the n-best and forward lattices (arcs and their max-plus
scores equal, padded and unpadded), the sum-semiring quantities (word-end
log posteriors, occupancies, confidences, arc posteriors) within rtol 1e-5
/ atol 1e-6 (logsumexp orders differ between the frameworks), consensus
decoding, keyword spotting, lattice oracles, and
ContinuousDecoder.predict_batch_with_confidence on single-Gaussian and GMM
models. Composites and features come from numpy seeds
(tests/test_lattice.py's)."""
import numpy as np
import pytest

from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu.models.gmm_hmm import GMMWordHMM as JGMM
from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu.models.hmm import stack_word_models as j_stack
from cs304_tpu.ops import lattice as jl
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.gmm_hmm import GMMWordHMM
from cs304_tpu_torch.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a
from cs304_tpu_torch.ops import lattice as tl
from test_torch_bigram_beam import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _pair_of_composites(seed=0, separated=False, labels=("A", "B", "S"), states=(3, 3, 2)):
    """The same composite built by both packages: random full-covariance
    words (D = 4), or words with far-apart means (separated)."""
    rng = np.random.default_rng(seed)
    tm, jm = [], []
    for i, (label, s) in enumerate(zip(labels, states)):
        if separated:
            center = (0.0, 100.0, -100.0)[i]
            means = np.stack([np.full(4, center + 10.0 * k) for k in range(s)]).astype(np.float32)
            covs = np.tile(np.eye(4, dtype=np.float32), (s, 1, 1))
        else:
            a = rng.normal(size=(s, 4, 2)).astype(np.float32)
            covs = a @ a.transpose(0, 2, 1) + np.eye(4, dtype=np.float32)
            means = rng.normal(size=(s, 4)).astype(np.float32) * 3
        tm.append(WordHMM(label, means, covs, uniform_forward_log_a(s)))
        jm.append(JWordHMM(label, means, covs, uniform_forward_log_a(s)))
    pen = -2.0 if separated else -4.0
    return stack_word_models(tm, pen), j_stack(jm, pen)


def _feats(seed, t):
    return (np.random.default_rng(seed).normal(size=(t, 4)) * 2).astype(np.float32)


def _arcs(lat):
    return [(a.start, a.end, a.label) for a in lat.sorted_arcs()]


def test_word_spans_and_nbest_lattice_match_jax():
    tc, jc = _pair_of_composites()
    feats = _feats(1, 40)
    log_b = np.asarray(jc.log_likelihoods(feats))
    rng = np.random.default_rng(2)
    for _ in range(5):
        path = rng.integers(0, tc.num_states, size=30)
        assert tl.path_word_spans(tc, path) == jl.path_word_spans(jc, path)
    for n in (1, 4, 8):
        want = jl.nbest_lattice(jc, feats, n=n, log_b=log_b)
        got = tl.nbest_lattice(tc, feats, n=n, log_b=log_b, device="cpu")
        assert _arcs(got) == _arcs(want) and got.num_frames == want.num_frames
        np.testing.assert_allclose([a.score for a in got.sorted_arcs()],
                                   [a.score for a in want.sorted_arcs()], rtol=1e-6)


def _word_paths(comp, rng, n_paths):
    """Seeded state paths over a composite as a decoder walks it: word
    instances left to right through their states (a state held 1-3 frames,
    a state skipped now and then), the same word repeated back to back,
    silence between; then uniformly random state paths, and paths of
    length 0, 1 and 2."""
    lowers, uppers = np.asarray(comp.lowers), np.asarray(comp.uppers)
    n_words = len(lowers)
    paths = [np.zeros(0, np.int64), np.array([3]), np.array([lowers[-1], uppers[-1]])]
    for _ in range(n_paths):
        states, w = [], int(rng.integers(n_words))
        for _i in range(int(rng.integers(1, 9))):
            w = w if rng.random() < 0.3 else int(rng.integers(n_words))
            s = lowers[w]
            while s <= uppers[w]:
                states += [s] * int(rng.integers(1, 4))
                s += 2 if rng.random() < 0.1 else 1
        paths.append(np.asarray(states))
        paths.append(rng.integers(0, comp.num_states, size=int(rng.integers(1, 60))))
    return paths


@pytest.mark.parametrize("which", ["flagship", "single-state-words"])
def test_path_word_spans_match_jax(which):
    """The span walk as one mask over the path, equal to JAX's loop on
    seeded paths with repeated words, silence, single-state words and
    lengths 0, 1 and 2."""
    from cs304_tpu_torch.models.hmm import flagship_models

    if which == "flagship":
        models = flagship_models()
    else:
        rng = np.random.default_rng(5)
        models = [WordHMM(f"w{i}", rng.normal(size=(n, 4)).astype(np.float32),
                          np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)),
                          uniform_forward_log_a(n)) for i, n in enumerate((1, 3, 1, 5, 2))]
    tc = stack_word_models(models, -100.0)
    jc = j_stack([JWordHMM(m.label, np.asarray(m.means), np.asarray(m.covariances),
                           np.asarray(m.log_a)) for m in models], -100.0)
    paths = _word_paths(tc, np.random.default_rng(len(which)), 40)
    want = [jl.path_word_spans(jc, path) for path in paths]
    for path, w in zip(paths, want):
        assert tl.path_word_spans(tc, path) == w, path
    # The batch form on the paths padded with garbage states past each length.
    lengths = [len(p) for p in paths]
    padded = np.random.default_rng(0).integers(-5, 3 * tc.num_states,
                                               size=(len(paths), max(lengths) + 3))
    for i, p in enumerate(paths):
        padded[i, : len(p)] = p
    assert tl.path_word_spans_batch(tc, padded, lengths) == want


@pytest.mark.parametrize("t,pad", [(40, 0), (37, 27), (2, 0)])
def test_forward_lattice_and_posteriors_match_jax(t, pad):
    tc, jc = _pair_of_composites()
    feats = _feats(3, t)
    if pad:
        feats = np.concatenate([feats, np.full((pad, 4), 7.7, np.float32)])
    log_b = np.asarray(jc.log_likelihoods(feats))
    kw = {"length": t} if pad else {}
    for beam in (5.0, 30.0):
        want = jl.forward_lattice(jc, feats, beam=beam, log_b=log_b, posteriors=True, **kw)
        got = tl.forward_lattice(tc, feats, beam=beam, log_b=log_b, posteriors=True,
                                 device="cpu", **kw)
        assert _arcs(got) == _arcs(want) and got.num_frames == t
        # Max-plus arc scores: bitwise alpha and beta, summed in float64.
        assert [a.score for a in got.sorted_arcs()] == [a.score for a in want.sorted_arcs()]
        np.testing.assert_allclose([a.posterior for a in got.sorted_arcs()],
                                   [a.posterior for a in want.sorted_arcs()],
                                   rtol=RTOL, atol=ATOL)
    for fn in ("word_end_log_posteriors", "word_occupancy_posteriors"):
        np.testing.assert_allclose(
            getattr(tl, fn)(tc, feats, log_b=log_b, device="cpu", **kw),
            getattr(jl, fn)(jc, feats, log_b=log_b, **kw), rtol=RTOL, atol=ATOL)
    occ = tl.word_occupancy_posteriors(tc, feats, log_b=log_b, device="cpu", **kw)
    # Every path occupies one state a frame (float32 sums of ~60 terms).
    np.testing.assert_allclose(occ.sum(axis=1), 1.0, rtol=1e-4)


def test_word_confidences_single_and_batch_match_jax():
    tc, jc = _pair_of_composites(4)
    feats = [_feats(10 + i, t) for i, t in enumerate((40, 23, 31, 40, 129))]
    want = jl.word_confidences_batch(jc, feats)
    got = tl.word_confidences_batch(tc, feats, device="cpu")
    for g_utt, w_utt in zip(got, want):
        assert [g[:3] for g in g_utt] == [w[:3] for w in w_utt]
        np.testing.assert_allclose([g[3] for g in g_utt], [w[3] for w in w_utt],
                                   rtol=RTOL, atol=ATOL)
    for f, g_utt in zip(feats[:2], got):
        single = tl.word_confidences(tc, f, device="cpu")
        assert [s[:3] for s in single] == [g[:3] for g in g_utt]
        w_single = jl.word_confidences(jc, f)
        np.testing.assert_allclose([s[3] for s in single], [w[3] for w in w_single],
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match=">= 2 frames"):
        tl.word_confidences_batch(tc, [_feats(0, 1)], device="cpu")


def test_separated_acoustics_consensus_and_keyword_spotting():
    tc, jc = _pair_of_composites(separated=True, labels=("A", "B", "C"), states=(3, 3, 3))
    rng = np.random.default_rng(5)
    traj = [0.0, 10.0, 20.0, 100.0, 110.0, 120.0]  # word A then word B
    feats = np.concatenate([np.full((4, 4), c, np.float32)
                            + rng.normal(size=(4, 4)).astype(np.float32) * 0.05
                            for c in traj])
    for kw in ("A", "B", "C"):
        want = jl.spot_keyword(jc, feats, kw, threshold=0.5)
        got = tl.spot_keyword(tc, feats, kw, threshold=0.5, device="cpu")
        assert [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                                   rtol=RTOL, atol=ATOL)
    hits = tl.spot_keyword(tc, feats, "A", device="cpu")
    assert len(hits) == 1 and hits[0][2] > 0.95 and hits[0][0] == 0
    with pytest.raises(ValueError):
        tl.spot_keyword(tc, feats, "X", device="cpu")
    padded = np.concatenate([feats, np.zeros((8, 4), np.float32)])
    for f, kw in ((feats, {}), (padded, {"length": 24})):
        assert tl.consensus_decode(tc, f, skip_silence=False, device="cpu", **kw) == \
            jl.consensus_decode(jc, f, skip_silence=False, **kw) == "AB"


def test_lattice_oracles_match_jax():
    tc, jc = _pair_of_composites(6)
    feats = _feats(6, 30)
    log_b = np.asarray(jc.log_likelihoods(feats))
    got = tl.forward_lattice(tc, feats, beam=20.0, log_b=log_b, device="cpu")
    want = jl.forward_lattice(jc, feats, beam=20.0, log_b=log_b)
    for truth in ("A", "AB", "BA", "ABA", "", "BBB"):
        assert got.contains(truth) == want.contains(truth)
        assert got.oracle_edits(truth) == want.oracle_edits(truth)
    assert got.to_dot() == want.to_dot()


@pytest.mark.parametrize("gmm", [False, True])
def test_decoder_confidences_match_jax(gmm):
    rng = np.random.default_rng(8)
    tmodels, jmodels = {}, {}
    for label, s in (("A", 3), ("B", 3), ("S", 2)):
        k = 2 if gmm else 1
        a = rng.normal(size=(s, k, 4, 2)).astype(np.float32)
        covs = a @ a.transpose(0, 1, 3, 2) + np.eye(4, dtype=np.float32)
        means = rng.normal(size=(s, k, 4)).astype(np.float32) * 3
        if gmm:
            w = np.full((s, k), 1.0 / k, np.float32)
            tmodels[label] = GMMWordHMM(label, means, covs, w, uniform_forward_log_a(s))
            jmodels[label] = JGMM(label, means, covs, w, uniform_forward_log_a(s))
        else:
            tmodels[label] = WordHMM(label, means[:, 0], covs[:, 0], uniform_forward_log_a(s))
            jmodels[label] = JWordHMM(label, means[:, 0], covs[:, 0], uniform_forward_log_a(s))
    feats = [_feats(20 + i, t) for i, t in enumerate((30, 22, 41))]
    tdec = ContinuousDecoder(tmodels, penalty=-4.0, device="cpu")
    want = JDecoder(jmodels, penalty=-4.0).predict_batch_with_confidence(feats)
    got = tdec.predict_batch_with_confidence(feats)
    preds = tdec.predict_batch(feats)
    # On the port's own emissions the JAX passes give the same confidences
    # within the sum-semiring tolerance.
    own = [tdec._gmm_log_b(f).numpy() if gmm else
           tdec.composite.log_likelihoods(f, device="cpu").numpy() for f in feats]
    same_b = jl.word_confidences_batch(j_stack(list(jmodels.values()) if not gmm else
                                               [JWordHMM(m.label, m.means[:, 0],
                                                         m.covariances[:, 0], m.log_a)
                                                for m in jmodels.values()], -4.0),
                                       feats, log_b=own)
    for g_utt, w_utt, b_utt, pred in zip(got, want, same_b, preds):
        assert [g[:3] for g in g_utt] == [w[:3] for w in w_utt] == [b[:3] for b in b_utt]
        np.testing.assert_allclose([g[3] for g in g_utt], [b[3] for b in b_utt],
                                   rtol=RTOL, atol=ATOL)
        # End to end each package scores its own emissions: a log posterior
        # is a difference of float32 sums of magnitude |log Z|, so it keeps
        # only an ulp of |log Z| (measured here: up to 6.1e-5 relative).
        np.testing.assert_allclose([g[3] for g in g_utt], [w[3] for w in w_utt],
                                   rtol=2e-4, atol=1e-5)
        assert "".join(lab for lab, *_ in g_utt) == pred
        assert all(0.0 <= c <= 1.0 for *_, c in g_utt)
