"""Checkpoints cross the two packages: a model tree saved by the JAX
package's save_models loads in the port (arrays identical, decode equal),
and the port's save_models writes a tree the JAX package loads."""
import numpy as np
import pytest

from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu.utils.checkpoint import load_models as j_load
from cs304_tpu.utils.checkpoint import save_models as j_save
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import (
    composite_from_arrays,
    flagship_models,
    from_numpy_models,
    stack_word_models,
)
from cs304_tpu_torch.utils.checkpoint import load_manifest, load_models, save_models


def _jax_models():
    return [JWordHMM(label=m.label, means=m.means, covariances=m.covariances,
                     log_a=m.log_a) for m in flagship_models(seed=3)]


def _features(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(rng.integers(30, 90)), 39)).astype(np.float32)
            for _ in range(n)]


def test_jax_checkpoint_loads_in_port(tmp_path):
    jmodels = _jax_models()
    j_save(jmodels, str(tmp_path), frontend={"normalization": "per_frame"})
    loaded = load_models(str(tmp_path))
    assert list(loaded) == sorted(m.label for m in jmodels)
    for jm in jmodels:
        tm = loaded[jm.label]
        for field in ("means", "covariances", "log_a"):
            a, b = getattr(tm, field), getattr(jm, field)
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert load_manifest(str(tmp_path))["frontend"] == {"normalization": "per_frame"}
    feats = _features()
    want = JDecoder(jmodels, penalty=-100.0).predict_batch(feats)
    assert ContinuousDecoder(loaded, penalty=-100.0,
                             device="cpu").predict_batch(feats) == want


def test_weight_conversion_matches_checkpoint(tmp_path):
    """from_numpy_models / composite_from_arrays carry the JAX models'
    parameters exactly as the checkpoint does."""
    jmodels = _jax_models()
    j_save(jmodels, str(tmp_path))
    converted = from_numpy_models(
        [m.label for m in jmodels], [m.means for m in jmodels],
        [m.covariances for m in jmodels], [m.log_a for m in jmodels],
    )
    loaded = load_models(str(tmp_path))
    feats = _features(1)
    a = ContinuousDecoder(converted, penalty=-100.0, device="cpu")
    b = ContinuousDecoder(loaded, penalty=-100.0, device="cpu")
    assert a.predict_batch(feats) == b.predict_batch(feats)
    stacked = stack_word_models(sorted(converted, key=lambda m: m.label), -100.0)
    comp = composite_from_arrays(stacked.labels, stacked.state_counts,
                                 stacked.means, stacked.covariances,
                                 stacked.log_a, -100.0)
    np.testing.assert_array_equal(comp.lower_of_state, a.composite.lower_of_state)
    np.testing.assert_array_equal(comp.log_a, a.composite.log_a)
    with pytest.raises(ValueError):
        from_numpy_models(["1"], [], [], [])


def test_port_checkpoint_loads_in_jax(tmp_path):
    models = flagship_models(seed=4)
    save_models(models, str(tmp_path), tier="words")
    jloaded = j_load(str(tmp_path))
    for m in models:
        np.testing.assert_array_equal(jloaded[m.label].covariances, m.covariances)
    assert load_manifest(str(tmp_path))["format"] == "cs304_tpu.npz.v1"


def test_gmm_checkpoint_raises(tmp_path):
    folder = tmp_path / "1"
    folder.mkdir()
    np.savez(folder / "params.npz", means=np.zeros((5, 2, 3), np.float32),
             covariances=np.zeros((5, 2, 3, 3), np.float32),
             log_a=np.zeros((5, 5), np.float32),
             weights=np.ones((5, 2), np.float32))
    with pytest.raises(NotImplementedError):
        load_models(str(tmp_path))
