"""The port's ContinuousDecoder on the backends and precision tiers it took
over last (CPU tensors, so every kernel wrapper runs its plain version)
against the JAX package's decoder on the 58-state flagship:

- backend "scan" (the dense trellis) and "pallas" (the dense trellis
  kernel's path; interpret-mode Pallas on the JAX side): transcripts equal,
  scores within rtol 1e-4 (the emissions differ in float32 summation order
  only);
- emission_precision "high" with emissions="quad": transcripts equal to the
  JAX decoder running its in-kernel hi/lo tier (interpret mode).
"""
import numpy as np
import pytest
import torch

from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import flagship_composite, flagship_models
from cs304_tpu_torch.ops.cuda import emission as temission
from test_torch_decoder import _jax_models, _sampled_features


@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("emissions", ["whiten", "quad"])
def test_dense_backends_match_jax(backend, emissions):
    feats = _sampled_features(7, 8)
    want = JDecoder(_jax_models(), penalty=-100.0, backend=backend,
                    emissions=emissions).predict_batch(feats)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, backend=backend,
                            emissions=emissions, device="cpu")
    assert dec.backend == backend
    assert dec.predict_batch(feats) == want
    assert any(len(w) > 1 for w in want)


def test_dense_backend_viterbi_batch_matches_jax_scan():
    feats = _sampled_features(8, 5) + [np.zeros((60, 39), np.float32)]
    j_s, j_p, j_l = JDecoder(_jax_models(), penalty=-100.0,
                             backend="scan").viterbi_batch(feats)
    t_s, t_p, t_l = ContinuousDecoder(flagship_models(), penalty=-100.0,
                                      backend="pallas", device="cpu").viterbi_batch(feats)
    np.testing.assert_array_equal(t_l, j_l)
    np.testing.assert_allclose(t_s, j_s, rtol=1e-4)
    comp = flagship_composite()
    for i, n in enumerate(t_l):
        assert comp.path_to_labels(t_p[i, :n]) == comp.path_to_labels(j_p[i, :n])


def test_penalty_setter_rebuilds_the_dense_transitions():
    feats = _sampled_features(9, 4)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, backend="scan",
                            device="cpu")
    dec.penalty = -5000.0
    fresh = ContinuousDecoder(flagship_models(), penalty=-5000.0, backend="scan",
                              device="cpu")
    assert torch.equal(dec._trans, fresh._trans)
    assert dec.predict_batch(feats) == fresh.predict_batch(feats)


@pytest.mark.parametrize("backend", ["fast", "pallas"])
def test_high_tier_matches_jax_kernel_tier(backend):
    feats = _sampled_features(10, 8)
    want = JDecoder(_jax_models(), penalty=-100.0, backend="scanfree",
                    emissions="quad", emission_precision="high").predict_batch(feats)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, backend=backend,
                            emissions="quad", emission_precision="high", device="cpu")
    before = temission.emission_split.launches
    assert dec.predict_batch(feats) == want
    assert temission.emission_split.launches == before  # CPU: the plain version
    # The tier's cached nhp split is the one the wrapper would make.
    for got, ref in zip(dec._nhp_split, temission.split_hi_lo(dec._quad[0])):
        assert torch.equal(got, ref)


def test_default_tier_decodes_through_the_one_pass_version():
    feats = _sampled_features(11, 4)
    dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                            emission_precision="default", device="cpu")
    highest = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                                device="cpu")
    batch = torch.as_tensor(3 * np.random.default_rng(0).normal(size=(3, 20, 39)),
                            dtype=torch.float32)
    lb = dec._log_b(batch)
    nhp, lin, const = dec._quad
    want = temission.emission_split_plain(batch.reshape(-1, 39),
                                          dec._nhp_split[0], None, lin, const, 1)
    np.testing.assert_array_equal(lb.reshape(-1, 128)[:, :58].numpy(),
                                  want[:, :58].numpy())
    assert not torch.equal(lb, highest._log_b(batch))
    assert len(dec.predict_batch(feats)) == len(feats)
