"""The port's ContinuousTrainer against cs304_tpu's, on the tiny corpus of
tests/test_torch_train_fused.py: silence bootstrap, then 4 fused Viterbi
iterations with on_empty_state="keep".

Tolerances: the same iteration count (convergence is discrete here: the
means stop moving once the paths stop changing); means within rtol 1e-5 /
atol 1e-5, covariances within rtol 1e-4 / atol 1e-5, log_a within atol 1e-6
with -inf at the same places (the sum order differs between XLA and torch).
Also: the "fail" empty-slot policy, save_state / resume, the trained models'
checkpoint round trip, and every option that is not ported yet (and the
two that were refused until they were: update="baum_welch" and GMM models).
"""
import os

import numpy as np
import pytest

from cs304_tpu.models.train_continuous import (
    ContinuousTrainConfig as JConfig,
    ContinuousTrainer as JTrainer,
)
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.train_continuous import (
    ContinuousTrainConfig,
    ContinuousTrainer,
    HMMTrainMeanFail,
)
from cs304_tpu_torch.utils.checkpoint import load_models, save_models
from test_torch_train_fused import jax_models, make_corpus, make_models

CFG = dict(max_iterations=4, cov_reg=0.05, length_multiple=16,
           silence_bootstrap=True, on_empty_state="keep")


def _copy(models):
    return {k: type(v)(label=v.label, means=v.means.copy(),
                       covariances=v.covariances.copy(), log_a=v.log_a.copy())
            for k, v in models.items()}


@pytest.fixture(scope="module")
def trained():
    models = make_models(seed=0)
    labeled = make_corpus(models, ["12", "321", "13"], 4, seed=3)
    jt = JTrainer(jax_models(models), JConfig(**CFG))
    n_jax = jt.train(labeled)
    tt = ContinuousTrainer(_copy(models), ContinuousTrainConfig(**CFG), device="cpu")
    n_port = tt.train(labeled)
    return dict(models=models, labeled=labeled, jt=jt, tt=tt,
                n_jax=n_jax, n_port=n_port)


def _assert_params_match(jt, tt):
    np.testing.assert_allclose(tt.means_g, jt.means_g, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.covs_g, jt.covs_g, rtol=1e-4, atol=1e-5)
    fin = np.isfinite(jt.log_a_g)
    np.testing.assert_array_equal(fin, np.isfinite(tt.log_a_g))
    np.testing.assert_allclose(tt.log_a_g[fin], jt.log_a_g[fin], rtol=0, atol=1e-6)


def test_trainer_matches_jax_with_bootstrap(trained):
    assert trained["n_port"] == trained["n_jax"]
    _assert_params_match(trained["jt"], trained["tt"])
    tt, jt = trained["tt"], trained["jt"]
    assert tt.last_empty_slots == jt.last_empty_slots
    assert tt.last_frozen_labels == jt.last_frozen_labels
    # The bootstrap moved the silence model away from its boot init.
    i_s = tt.label_index["S"]
    assert not np.allclose(tt.means_g[i_s, :3], trained["models"]["S"].means)


def test_per_iteration_path_matches_device_loop(trained, tmp_path):
    """checkpoint_dir routes train() through the per-iteration loop; it must
    train to the device loop's parameters and iteration count, and its saved
    state must resume."""
    tt = ContinuousTrainer(_copy(trained["models"]), ContinuousTrainConfig(**CFG),
                           device="cpu")
    n = tt.train(trained["labeled"], checkpoint_dir=str(tmp_path))
    assert n == trained["n_port"]
    _assert_params_match(trained["jt"], tt)
    fresh = ContinuousTrainer(_copy(trained["models"]), ContinuousTrainConfig(**CFG),
                              device="cpu")
    assert fresh.resume(str(tmp_path)) == n
    for name in ("means_g", "covs_g", "log_a_g"):
        np.testing.assert_array_equal(getattr(fresh, name), getattr(tt, name))


def test_save_state_resume_round_trip(trained, tmp_path):
    tt = trained["tt"]
    tt.save_state(str(tmp_path))
    with np.load(os.path.join(tmp_path, "trainer_state.npz")) as z:
        assert sorted(z.files) == ["covs_g", "iterations_done", "log_a_g", "means_g"]
    other = ContinuousTrainer(_copy(trained["models"]), ContinuousTrainConfig(**CFG),
                              device="cpu")
    assert other.resume(str(tmp_path)) == tt._iterations_done
    got, want = other.models(), tt.models()
    for label in want:
        np.testing.assert_array_equal(got[label].means, want[label].means)
        np.testing.assert_array_equal(got[label].log_a, want[label].log_a)
    # The run had converged: resuming spends one iteration detecting it again
    # and changes nothing.
    assert trained["n_port"] < CFG["max_iterations"]
    assert other.train(trained["labeled"]) == tt._iterations_done + 1
    np.testing.assert_array_equal(other.means_g, tt.means_g)


def test_trained_models_checkpoint_round_trip_and_decode(trained, tmp_path):
    models = trained["tt"].models()
    save_models(models, str(tmp_path))
    loaded = load_models(str(tmp_path))
    assert sorted(loaded) == sorted(models)
    for label, m in models.items():
        np.testing.assert_array_equal(loaded[label].means, m.means)
        np.testing.assert_array_equal(loaded[label].covariances, m.covariances)
        np.testing.assert_array_equal(loaded[label].log_a, m.log_a)
    dec = ContinuousDecoder(loaded, penalty=-100.0, device="cpu")
    feats = [f for tr in ("12", "321") for f in trained["labeled"][tr][:2]]
    assert dec.predict_batch(feats) == ["12", "12", "321", "321"]


def test_empty_state_fail_raises():
    models = make_models(seed=4)
    labeled = make_corpus(models, ["12"], 3, seed=5)  # "3" never appears
    cfg = dict(CFG, on_empty_state="fail", silence_bootstrap=False)
    with pytest.raises(HMMTrainMeanFail):
        ContinuousTrainer(models, ContinuousTrainConfig(**cfg), device="cpu").train(labeled)


def _gmm_word(label="9", d=6):
    from cs304_tpu_torch.models.gmm_hmm import GMMWordHMM
    from cs304_tpu_torch.models.hmm import uniform_forward_log_a

    rng = np.random.default_rng(9)
    return GMMWordHMM(label, rng.normal(size=(5, 2, d)).astype(np.float32),
                      np.tile(np.eye(d, dtype=np.float32), (5, 2, 1, 1)),
                      np.full((5, 2), 0.5, np.float32), uniform_forward_log_a(5))


@pytest.mark.parametrize("what", ["baum_welch", "mesh", "legacy", "gmm"])
def test_unported_options_raise(what):
    """mesh= takes a data-parallel mesh (parallel/data_parallel.py;
    tests/test_torch_parallel_train.py trains on one): anything else is a
    TypeError. update="baum_welch", fused=False and GMM models
    were refused before they were ported: Baum-Welch and the legacy
    per-transcript trainer now train as the JAX trainer does (one iteration
    here; test_torch_train_bw.py and test_torch_train_legacy.py hold the
    rest), and GMM models fail in train() with a ValueError, as in the JAX
    trainer, naming GMMContinuousTrainer."""
    models = make_models(seed=0)
    cfg, kw = {}, {}
    if what in ("baum_welch", "legacy"):
        labeled = make_corpus(models, ["12", "3"], 2, seed=3)
        option = {"update": "baum_welch"} if what == "baum_welch" else {"fused": False}
        cfg = dict(max_iterations=1, cov_reg=0.05, silence_bootstrap=False, **option)
        tt = ContinuousTrainer(models, ContinuousTrainConfig(**cfg), device="cpu")
        jt = JTrainer(jax_models(models), JConfig(**cfg))
        assert tt.train(labeled) == jt.train(labeled) == 1
        for label, want in jt.models().items():
            np.testing.assert_allclose(tt.models()[label].means, want.means,
                                       rtol=1e-5, atol=1e-5)
        return
    if what == "gmm":
        from cs304_tpu.models.gmm_hmm import GMMWordHMM as JGMMWordHMM

        labeled = make_corpus(models, ["12"], 2, seed=3)
        g = _gmm_word()
        jmodels = jax_models(models)
        jmodels["9"] = JGMMWordHMM(g.label, g.means, g.covariances, g.weights, g.log_a)
        models["9"] = g
        with pytest.raises(ValueError):
            JTrainer(jmodels, JConfig(max_iterations=1)).train(labeled)
        with pytest.raises(ValueError, match="GMMContinuousTrainer"):
            ContinuousTrainer(models, ContinuousTrainConfig(max_iterations=1),
                              device="cpu").train(labeled)
        return
    with pytest.raises(TypeError, match="DeviceMesh"):
        ContinuousTrainer(models, ContinuousTrainConfig(**cfg), device="cpu", mesh=object())
