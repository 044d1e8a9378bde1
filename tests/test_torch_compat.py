"""The port's reference-compatible surface (cs304_tpu_torch/compat.py)
against the JAX package's (cs304_tpu/compat.py), on tests/test_compat.py's
cases, with ``device="cpu"``.

Every name of the JAX compat surface exists (the reference's export list
that tests/test_compat.py:91 checks, and import_reference_checkpoint).
Results against JAX on the same inputs: MFCC features within the front
ends' atol 1e-4 (tests/test_torch_mfcc.py); a trained word model within the
k-means parity tolerances (tests/test_torch_train_kmeans.py) when both
train from the same features, its Viterbi score within rtol 1e-5 and its
path equal; the isolated and continuous predictions of one checkpoint
equal; two embedded training iterations of HiddenMarkovModelTrainContinuous
from that checkpoint, saved, within the continuous trainer's parity
tolerances (tests/test_torch_train_continuous.py: means rtol 1e-5 /
atol 1e-5, covariances rtol 1e-4 / atol 1e-5, log_a atol 1e-6 with -inf
at the same places); DTW's template index equal and its distance within rtol 1e-4; the
reference-pickle importer's arrays bitwise.
"""
import os
import pickle
import sys
import types

import numpy as np
import pytest

from cs304_tpu import compat as jcompat
from cs304_tpu.data.synthetic import SyntheticTIDigits
from cs304_tpu.data.ti_digits import DIGIT_LABELS
from cs304_tpu_torch import compat
from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_cli_train import same_models

REFERENCE_EXPORTS = [
    "MFCC", "Segmentation", "DynamicTimeWarping", "TIDigits",
    "TI_DIGITS_LABELS", "DataLoader", "HiddenMarkovModel",
    "HiddenMarkovModelTrainable", "HiddenMarkovModelInference",
    "HiddenMarkovModelTrainContinuous", "Signal", "ModelCollection",
    "TI_DIGITS_LABEL_TYPE", "plot_confusion_matrix_from_lists",
    "plot_line", "CSVReader", "CSVWriter", "SignalSeparation",
]


@pytest.fixture(scope="module")
def corpus():
    return SyntheticTIDigits(num_train_speakers=3, num_test_speakers=1, takes_per_digit=2)


@pytest.fixture(scope="module")
def digit_ckpt(tmp_path_factory, corpus):
    """All 11 digit models and a 3-state silence model (from the clips'
    endpointed noise), trained by the port's compat surface."""
    folder = tmp_path_factory.mktemp("compat_ckpt")
    sep = compat.SignalSeparation()
    for label in DIGIT_LABELS:
        mfccs = compat.MFCC.batch(corpus.train_dataset[label], 16000, device="cpu")
        compat.HiddenMarkovModelTrainable.from_data(label, mfccs, 5, 4, device="cpu").save(
            str(folder))
        sep.remove_empty_batch(corpus.train_dataset[label])
    noises = [n for n in sep.get_all_noises() if len(n) >= 9 * sep.frame_size]
    compat.HiddenMarkovModelTrainable.from_data(
        "S", compat.MFCC.batch(noises, 16000, device="cpu"), 3, 4, device="cpu").save(str(folder))
    return str(folder)


def test_surface_names():
    assert sorted(compat.__all__) == sorted(jcompat.__all__) == sorted(REFERENCE_EXPORTS)
    for name in REFERENCE_EXPORTS + ["import_reference_checkpoint"]:
        assert hasattr(compat, name), name
    assert compat.TI_DIGITS_LABELS == jcompat.TI_DIGITS_LABELS


def test_mfcc_against_jax(corpus):
    sig = corpus.train_dataset["3"][0]
    got = compat.MFCC(sig, 16000, device="cpu").feature_vector
    want = jcompat.MFCC(sig, 16000).feature_vector
    assert got.shape == want.shape and got.shape[0] == 39
    np.testing.assert_allclose(got, want, atol=1e-4)
    batch = compat.MFCC.batch([sig, sig], 16000, device="cpu")
    np.testing.assert_allclose(batch[0], got.T, rtol=1e-5)
    with pytest.raises(ValueError):
        compat.MFCC(np.zeros((2, 100)), 16000, device="cpu")


def test_trainable_against_jax(tmp_path, corpus):
    mfccs = jcompat.MFCC.batch(corpus.train_dataset["5"], 16000)
    want = jcompat.HiddenMarkovModelTrainable.from_data("5", mfccs, 5, 6)
    got = compat.HiddenMarkovModelTrainable.from_data("5", mfccs, 5, 6, device="cpu")
    assert (got.num_of_states, got.dim_of_features) == (5, 39)
    np.testing.assert_allclose(got._core.means, np.asarray(want._core.means),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got._core.covariances, np.asarray(want._core.covariances),
                               rtol=1e-4, atol=1e-5)
    score, path = got.predict(mfccs[0])
    want_score, want_path = want.predict(mfccs[0])
    assert score == pytest.approx(want_score, rel=1e-5)
    np.testing.assert_array_equal(path, want_path)
    got.save(str(tmp_path))
    loaded = compat.HiddenMarkovModel.from_folder(str(tmp_path / "5"), device="cpu")
    assert str(loaded) == "5"
    score2, path2 = loaded.predict(mfccs[0])
    assert score2 == score
    np.testing.assert_array_equal(path2, path)
    # The JAX package reads the port's save, and the reverse.
    jloaded = jcompat.HiddenMarkovModel.from_folder(str(tmp_path / "5"))
    np.testing.assert_array_equal(np.asarray(jloaded._core.means), got._core.means)


def test_collection_and_inference_against_jax(digit_ckpt, corpus):
    clip = compat.MFCC.batch([corpus.test_dataset["7"][0]], 16000, device="cpu")[0]
    mc = compat.ModelCollection.load_from_files(digit_ckpt, device="cpu")
    jmc = jcompat.ModelCollection.load_from_files(digit_ckpt)
    assert mc.predict(clip) == jmc.predict(clip) == "7"
    assert mc.predict_continuous_controller(clip) == jmc.predict_continuous_controller(clip)
    inf = compat.HiddenMarkovModelInference.from_folder(digit_ckpt, list(DIGIT_LABELS),
                                                        device="cpu")
    jinf = jcompat.HiddenMarkovModelInference.from_folder(digit_ckpt, list(DIGIT_LABELS))
    for i in (inf, jinf):
        i._log_transition_probability_between_words = -250.0
    assert inf._decoder.penalty == -250.0
    assert inf.predict(clip) == jinf.predict(clip)
    trainer = compat.HiddenMarkovModelTrainContinuous.from_folder(
        digit_ckpt, list(DIGIT_LABELS), device="cpu")
    assert trainer._trainer.device.type == "cpu"


def test_train_continuous_against_jax(digit_ckpt, tmp_path):
    """HiddenMarkovModelTrainContinuous: from_folder, train and save on the
    same checkpoint and features, by each package."""
    sentences = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1,
                                  takes_per_digit=1, with_sentences=True).train_dataset
    labeled = {t: jcompat.MFCC.batch(list(u), 16000)
               for n in (2, 3) for t, u in sentences.get_all_n_digits(n).items()}
    labels = list(DIGIT_LABELS) + ["S"]
    for pkg, trainer in (
            ("port", compat.HiddenMarkovModelTrainContinuous.from_folder(digit_ckpt, labels,
                                                                         device="cpu")),
            ("jax", jcompat.HiddenMarkovModelTrainContinuous.from_folder(digit_ckpt, labels))):
        trainer.train(labeled, max_iterations=2)
        trainer.save(str(tmp_path / pkg))
    assert trainer._trainer.cfg.max_iterations == 2
    assert same_models(str(tmp_path / "port"), str(tmp_path / "jax")) == sorted(labels)


def test_dtw_against_jax(corpus):
    templates = [corpus.train_dataset[label][0] for label in ("1", "2", "3")]
    sample = corpus.train_dataset["2"][1]
    idx, dist = compat.DynamicTimeWarping(templates, sample, device="cpu").search()
    want_idx, want_dist = jcompat.DynamicTimeWarping(templates, sample).search()
    assert idx == want_idx == 1
    assert dist == pytest.approx(want_dist, rel=1e-4)


def test_ti_digits_tree_and_signal(tmp_path):
    from cs304_tpu_torch.audio.wav import write_wav_int16

    rng = np.random.default_rng(0)
    for split in ("TRAIN", "TEST"):
        base = os.path.join(tmp_path, "Adults", "TIDIGITS", split)
        os.makedirs(base)
        for name in ("1a.wav", "1b.wav", "82a.wav"):
            write_wav_int16(os.path.join(base, name),
                            rng.normal(0, 1000, 3200).astype(np.int16), 16000)
    td = compat.TIDigits(str(tmp_path), include_children=False)
    jtd = jcompat.TIDigits(str(tmp_path), include_children=False)
    assert set(td.train_dataset.labels) == set(jtd.train_dataset.labels) == {"1", "82"}
    np.testing.assert_array_equal(td.train_dataset.get_combined("1", 0),
                                  jtd.train_dataset.get_combined("1", 0))
    sig = np.arange(12, dtype=np.float32).reshape(6, 2)
    path = np.array([0, 0, 1, 1, 1, 2])
    got, want = compat.Signal(4, sig, path), jcompat.Signal(4, sig, path)
    for g, w in zip(got.order_by_state, want.order_by_state):
        assert (g is None and w is None) or np.array_equal(g, w)
    assert len(got.order_by_signal) == len(want.order_by_signal) == 6


def _reference_pickles(folder):
    """tests/test_compat.py's fabricated reference checkpoint (the pickle
    structure of hidden_markov_model.py:93-115, under its module paths)."""
    import scipy.stats

    pkg = types.ModuleType("loe_speech_recognition")
    tp_mod = types.ModuleType("loe_speech_recognition.transition_probability")
    hmm_mod = types.ModuleType("loe_speech_recognition.hidden_markov_model")
    ltp_cls = type("LogTransitionProbabilities", (), {"__module__": tp_mod.__name__})
    mn_cls = type("MultivariateNormal", (), {"__module__": hmm_mod.__name__})
    tp_mod.LogTransitionProbabilities = ltp_cls
    hmm_mod.MultivariateNormal = mn_cls
    saved = {m.__name__: sys.modules.get(m.__name__) for m in (pkg, tp_mod, hmm_mod)}
    sys.modules.update({m.__name__: m for m in (pkg, tp_mod, hmm_mod)})
    try:
        rng = np.random.default_rng(0)
        means = rng.normal(size=(3, 5)).astype(np.float32)
        covs = np.tile(np.eye(5, dtype=np.float32) * 0.5, (3, 1, 1))
        ltp = ltp_cls()
        ltp.num_of_states = 3
        ltp._core = {(0, 0): -0.5, (0, 1): -1.0, (1, 1): -0.3, (1, 2): -1.2, (2, 2): 0.0}
        mns = []
        for i in range(3):
            mn = mn_cls()
            mn.dim_of_features = 5
            mn._core = scipy.stats.multivariate_normal(mean=means[i], cov=covs[i])
            mns.append(mn)
        d = folder / "7"
        d.mkdir(parents=True)
        with open(d / "log_trans_probs.pickle", "wb") as f:
            pickle.dump(ltp, f, pickle.HIGHEST_PROTOCOL)
        with open(d / "multivariate_normals.pickle", "wb") as f:
            pickle.dump(mns, f, pickle.HIGHEST_PROTOCOL)
    finally:
        for name, mod in saved.items():
            if mod is None:
                del sys.modules[name]
            else:
                sys.modules[name] = mod
    return means, covs


def test_import_reference_checkpoint_against_jax(tmp_path):
    from cs304_tpu_torch.models.hmm import WordHMM
    from cs304_tpu_torch.utils.checkpoint import load_models

    means, covs = _reference_pickles(tmp_path / "ckpt")
    got = compat.import_reference_checkpoint(str(tmp_path / "ckpt"),
                                             save_npz_to=str(tmp_path / "npz"))
    want = jcompat.import_reference_checkpoint(str(tmp_path / "ckpt"))
    assert set(got) == set(want) == {"7"}
    assert isinstance(got["7"], WordHMM)
    for field in ("means", "covariances", "log_a"):
        np.testing.assert_array_equal(getattr(got["7"], field),
                                      np.asarray(getattr(want["7"], field)))
    np.testing.assert_allclose(got["7"].means, means, atol=1e-6)
    assert got["7"].log_a[2, 0] == -np.inf
    np.testing.assert_array_equal(load_models(str(tmp_path / "npz"))["7"].covariances,
                                  got["7"].covariances)
