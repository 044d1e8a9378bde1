"""The port's forced aligner (models/align.py) against the JAX package's, on
the CPU: the same models (single-Gaussian and K=2 GMM, D = 6) and the same
seeded utterances through both.

Tolerances: scores within rtol 1e-5 / atol 1e-3 (whitening sums in other
orders; alignments of ~60 frames score ~-500), -inf at the same rows;
segments (words, positions, frame and second ranges, state runs) equal for
every row with a finite score. A row too short to reach the sentence's last
state scores -inf, and its path is the trellis's tie rule over -inf cells,
which the banded kernel on a card and the dense plain trellis resolve
differently (ROADMAP W3): such rows are compared by score only.
"""
from dataclasses import asdict

import numpy as np
import pytest

from cs304_tpu.models.align import ForcedAligner as JAligner
from cs304_tpu.models.gmm_hmm import GMMWordHMM as JGMMWordHMM
from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu_torch.data.batching import make_signals
from cs304_tpu_torch.models import ForcedAligner, flagship_models
from cs304_tpu_torch.models.train_continuous_gmm import promote_to_gmm
from test_torch_train_fused import jax_models, make_corpus, make_models


def _jax_gmm(models):
    return {k: JGMMWordHMM(label=m.label, means=m.means, covariances=m.covariances,
                           weights=m.weights, log_a=m.log_a) for k, m in models.items()}


def _same(port_results, jax_results):
    assert len(port_results) == len(jax_results)
    for p, j in zip(port_results, jax_results):
        assert (p.transcript, p.sentence, p.num_frames) == (j.transcript, j.sentence,
                                                          j.num_frames)
        assert np.isfinite(p.score) == np.isfinite(j.score)
        if not np.isfinite(j.score):
            assert p.score == j.score
            continue
        assert p.score == pytest.approx(j.score, rel=1e-5, abs=1e-3)
        assert [asdict(w) for w in p.words] == [asdict(w) for w in j.words]


@pytest.fixture(scope="module")
def setup():
    models = make_models(seed=2)
    labeled = make_corpus(models, ["12", "321", "3"], 3, seed=6)
    return models, labeled


@pytest.mark.parametrize("insert_sil,cross_word", [
    (True, "exit_only"), (True, "band"), (False, "exit_only")])
def test_align_batch_matches_jax(setup, insert_sil, cross_word):
    models, labeled = setup
    port = ForcedAligner(models, insert_sil=insert_sil, cross_word=cross_word,
                         device="cpu")
    jax = JAligner(jax_models(models), insert_sil=insert_sil, cross_word=cross_word)
    for transcript, feats in labeled.items():
        if not insert_sil:  # the silence-free sentence of the same audio
            feats = [f[4:-4] for f in feats]
        _same(port.align_batch(feats, transcript), jax.align_batch(feats, transcript))
    one = labeled["321"][1]
    _same([port.align(one, "321")], [jax.align(one, "321")])
    res = port.align(one, "321")
    assert [w.word for w in res.word_segments()] == list("321")
    assert res.words[0].start_frame == 0 and res.words[-1].end_frame == len(one)


def test_too_short_rows_score_minus_inf_as_in_jax(setup):
    """A 3-frame utterance cannot cross the 7-word sentence S1S2S3S: -inf in
    both packages, while the other rows of the batch align as in JAX."""
    models, labeled = setup
    feats = [labeled["321"][0][:3], labeled["321"][0]]
    port = ForcedAligner(models, device="cpu").align_batch(feats, "321")
    jax = JAligner(jax_models(models)).align_batch(feats, "321")
    assert port[0].score == jax[0].score == -np.inf
    _same(port, jax)


def test_gmm_align_matches_jax(setup):
    models, labeled = setup
    gmm = promote_to_gmm(models, 2)
    port = ForcedAligner(gmm, device="cpu")
    jax = JAligner(_jax_gmm(gmm))
    for transcript in ("12", "321"):
        _same(port.align_batch(labeled[transcript], transcript),
              jax.align_batch(labeled[transcript], transcript))


def test_align_signals_matches_jax():
    """Raw audio through each package's own MFCC front end, then the
    flagship's models (39-dim)."""
    models = {m.label: m for m in flagship_models()}
    signals = list(make_signals(2, 0.6, seed=3))
    port = ForcedAligner(models, device="cpu").align_signals(signals, "1Z")
    jax = JAligner(jax_models(models)).align_signals(signals, "1Z")
    _same(port, jax)


def test_validation_errors_match_jax(setup):
    models, labeled = setup
    feats = labeled["12"]
    with pytest.raises(ValueError, match="cross_word"):
        ForcedAligner(models, cross_word="free", device="cpu")
    no_sil = {k: v for k, v in models.items() if k != "S"}
    with pytest.raises(ValueError, match="silence"):
        ForcedAligner(no_sil, device="cpu")
    aligner = ForcedAligner(models, device="cpu")
    jax = JAligner(jax_models(models))
    for args in (([], "12"), ([np.zeros((0, 6), np.float32)], "12"),
                 ([np.zeros(6, np.float32)], "12"), (feats, "19"), (feats, "")):
        with pytest.raises(ValueError) as port_err:
            aligner.align_batch(*args)
        with pytest.raises(ValueError) as jax_err:
            jax.align_batch(*args)
        assert str(port_err.value) == str(jax_err.value)
