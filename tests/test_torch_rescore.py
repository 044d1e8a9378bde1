"""The port's lattice rescoring and confusion networks
(cs304_tpu_torch.ops.rescore) against the JAX package's ops/rescore.py on
the CPU, on the same log_b: arc-local acoustic scores bitwise (the same
max-plus adds), lattice_rescore under the flat penalty and a bigram (with
and without boundary terms) and lattice_rescore_trigram giving the same
scores, texts and arcs, the exhaustive lattice's rescore equal to the
port's own first-pass decode (flat: dense trellis; bigram: the dense
trellis on the (S, S) pair matrix), confusion networks with the same slots
(posteriors within rtol 1e-5 / atol 1e-6) and cn_decode's texts."""
import numpy as np
import pytest
import torch

from cs304_tpu.ops import lattice as jl
from cs304_tpu.ops import lm as jlm
from cs304_tpu.ops import rescore as jr
from cs304_tpu_torch.ops import lattice as tl
from cs304_tpu_torch.ops import lm as tlm
from cs304_tpu_torch.ops import rescore as tr
from cs304_tpu_torch.ops.viterbi import viterbi_composite
from test_torch_lattice import _feats, _pair_of_composites
from test_torch_bigram_beam import one_torch_thread  # noqa: F401

BIGRAM_CORPUS = ["AB", "BA", "AAB", "BSA", "ABBA"]


def _lattices(tc, jc, feats, log_b, beam=25.0):
    return (tl.forward_lattice(tc, feats, beam=beam, log_b=log_b, device="cpu"),
            jl.forward_lattice(jc, feats, beam=beam, log_b=log_b))


def test_arc_acoustic_scores_are_bitwise_jax():
    tc, jc = _pair_of_composites(1)
    feats = _feats(1, 45)
    log_b = np.asarray(jc.log_likelihoods(feats))
    lat_t, lat_j = _lattices(tc, jc, feats, log_b, beam=60.0)
    arcs = lat_j.sorted_arcs() + tr.exhaustive_lattice(tc, 9).arcs[:200]
    got = tr.arc_acoustic_scores(tc, arcs, log_b=log_b, device="cpu")
    want = jr.arc_acoustic_scores(jc, arcs, log_b=log_b)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).mean() > 0.5
    assert tr.arc_acoustic_scores(tc, [], log_b=log_b, device="cpu").shape == (0,)
    # Additivity: the 1-best's segmentation re-summed with one penalty a
    # boundary is the dense Viterbi score.
    score, path = viterbi_composite(torch.tensor(log_b), tc.log_a, tc.lower_of_state,
                                    tc.is_entry, tc.is_exit, tc.penalty,
                                    quirk_backtrace=False)
    spans = tl.path_word_spans(tc, path.numpy())
    one = [tl.LatticeArc(st, en, tc.labels[w], 0.0) for st, en, w in spans]
    ac = tr.arc_acoustic_scores(tc, one, log_b=log_b, device="cpu")
    np.testing.assert_allclose(ac.sum() + tc.penalty * (len(one) - 1), float(score),
                               rtol=1e-6)


@pytest.mark.parametrize("lm", [None, "bigram", "bigram-boundaries", "trigram"])
def test_lattice_rescore_matches_jax(lm):
    tc, jc = _pair_of_composites(2)
    feats = _feats(2, 36)
    log_b = np.asarray(jc.log_likelihoods(feats))
    lat_t, lat_j = _lattices(tc, jc, feats, log_b)
    kw_t, kw_j = {"log_b": log_b, "device": "cpu"}, {"log_b": log_b}
    if lm is None:
        got = tr.lattice_rescore(tc, lat_t, penalty=-6.0, **kw_t)
        want = jr.lattice_rescore(jc, lat_j, penalty=-6.0, **kw_j)
    elif lm == "trigram":
        got = tr.lattice_rescore_trigram(
            tc, lat_t, tlm.train_word_trigram(BIGRAM_CORPUS, tc.labels), lm_weight=2.0,
            boundaries=True, **kw_t)
        want = jr.lattice_rescore_trigram(
            jc, lat_j, jlm.train_word_trigram(BIGRAM_CORPUS, jc.labels), lm_weight=2.0,
            boundaries=True, **kw_j)
    else:
        b = lm.endswith("boundaries")
        got = tr.lattice_rescore(tc, lat_t, bigram=tlm.train_word_bigram(BIGRAM_CORPUS,
                                                                         tc.labels),
                                 lm_weight=3.0, boundaries=b, **kw_t)
        want = jr.lattice_rescore(jc, lat_j, bigram=jlm.train_word_bigram(BIGRAM_CORPUS,
                                                                          jc.labels),
                                  lm_weight=3.0, boundaries=b, **kw_j)
    assert got[0] == want[0] and got[1] == want[1]
    assert [(a.start, a.end, a.label) for a in got[2]] == \
        [(a.start, a.end, a.label) for a in want[2]]


def test_exhaustive_rescore_is_full_search():
    """Rescoring every possible arc reproduces the port's first-pass dense
    decode, flat and under a bigram LM (tests/test_rescore.py's oracle)."""
    tc, _jc = _pair_of_composites(3)
    feats = _feats(3, 11)
    log_b = tc.log_likelihoods(feats, device="cpu")
    lat = tr.exhaustive_lattice(tc, 11)
    topo = (tc.log_a, tc.lower_of_state, tc.is_entry, tc.is_exit)
    bg = tlm.train_word_bigram(BIGRAM_CORPUS, tc.labels)
    for bigram in (None, bg):
        pen = (torch.as_tensor(tlm.pair_penalty_matrix(tc, bg, 1.5)) if bigram
               else tc.penalty)
        score, path = viterbi_composite(log_b, *topo, pen, quirk_backtrace=False)
        got = tr.lattice_rescore(tc, lat, log_b=log_b, bigram=bigram, lm_weight=1.5,
                                 skip_silence=False, device="cpu")
        np.testing.assert_allclose(got[0], float(score), rtol=1e-6)
        assert got[1] == "".join(tc.path_to_labels(path.numpy(), skip_silence=False))


def test_confusion_networks_match_jax():
    tc, jc = _pair_of_composites(4)
    rng = np.random.default_rng(4)
    confident = []
    for lab in ("A", "S", "B"):
        w = tc.labels.index(lab)
        for s in range(tc.lowers[w], tc.uppers[w] + 1):
            confident += [tc.means[s] + rng.normal(size=4).astype(np.float32) * 0.05
                          for _ in range(4)]
    for feats, beam in ((np.asarray(confident, np.float32), 30.0), (_feats(5, 40), 60.0)):
        log_b = np.asarray(jc.log_likelihoods(feats))
        got = tr.confusion_network(tc, feats, beam=beam, log_b=log_b, device="cpu")
        want = jr.confusion_network(jc, feats, beam=beam, log_b=log_b)
        assert [(s.start, s.end, s.pivot, sorted(s.hyps)) for s in got] == \
            [(s.start, s.end, s.pivot, sorted(s.hyps)) for s in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose([g.hyps[k] for k in sorted(g.hyps)],
                                       [w.hyps[k] for k in sorted(w.hyps)],
                                       rtol=1e-5, atol=1e-6)
        assert tr.cn_decode(got) == jr.cn_decode(want)
    assert tr.cn_decode(got[:0]) == ""


def test_rescore_disconnected_lattice_raises():
    tc, _jc = _pair_of_composites(5)
    lat = tl.Lattice(num_frames=10, arcs=[tl.LatticeArc(0, 4, "A", 0.0),
                                          tl.LatticeArc(5, 10, "B", 0.0)])
    with pytest.raises(ValueError, match="spans"):
        tr.lattice_rescore(tc, lat, features=np.zeros((10, 4), np.float32), device="cpu")
