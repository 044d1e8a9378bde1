"""K-mixture GMM emissions (ops/gaussian.py), the GMM word models and their
three trainers (models/gmm_hmm.py) and the GMM lift of models/stacking.py,
against the JAX package on the same numpy inputs from a seed.

Tolerances:
  - whitening emissions (and weighted components): rtol 1e-5 / atol 1e-4
    (float32 sums in other orders);
  - quad emissions at "highest" and "high" against JAX's whitening
    emissions: rtol 1e-4 / atol 5e-2, the drift tests/test_gmm_decoder.py:105
    allows the quad layout ("high" runs its bf16 plain version on the CPU);
    "default" (one bf16 pass, which drifts past that) against the JAX
    package's own one-pass composition over the S*K Gaussians then its
    logsumexp over K (rtol 1e-5 / atol 2e-3, as
    test_torch_emission_tiers.py holds the Gaussian "default" tier; JAX's
    CPU Precision.DEFAULT is float32, so it is not the oracle);
  - trainers: iteration-for-iteration the same algorithm; means, weights and
    log_a within rtol 1e-4 / atol 1e-4 and covariances within rtol 1e-3 /
    atol 1e-4 after several EM iterations (-inf in log_a at the same
    places); Viterbi scores rtol 1e-5, paths equal;
  - pad_mixture_params, stack_models' lift and the checkpoint arrays:
    bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.models import gmm_hmm as jg
from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu.models.stacking import stack_models as j_stack_models
from cs304_tpu.models.train_kmeans import SegmentalKMeansConfig as JKCfg
from cs304_tpu.ops import gaussian as jga
from cs304_tpu_torch.models import gmm_hmm as tg
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import WordHMM, uniform_forward_log_a
from cs304_tpu_torch.models.stacking import stack_models
from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig
from cs304_tpu_torch.ops import gaussian as tga


def _close(got, want, rtol=1e-5, atol=1e-4, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol, err_msg=what)


def _gmm_arrays(seed, s=6, k=3, d=5, pad_last=True):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(s, k, d, 2)).astype(np.float32)
    covs = a @ a.transpose(0, 1, 3, 2) + np.eye(d, dtype=np.float32)
    means = rng.normal(size=(s, k, d)).astype(np.float32) * 2
    weights = rng.uniform(0.2, 1.0, size=(s, k)).astype(np.float32)
    if pad_last:
        weights[:, -1] = 0.0  # a padded mixture: log 0 drops out
    weights /= weights.sum(axis=1, keepdims=True)
    frames = rng.normal(size=(24, d)).astype(np.float32) * 2
    return means, covs, weights, frames


def test_gmm_whitening_emissions_match_jax():
    means, covs, weights, frames = _gmm_arrays(0)
    jp = jga.make_gmm_params(jnp.asarray(means), jnp.asarray(covs), jnp.asarray(weights))
    tp = tga.make_gmm_params(means, covs, weights, device="cpu")
    for name in ("means", "log_norm", "log_weights"):
        _close(getattr(tp, name), getattr(jp, name), what=name)
    assert (tp.num_states, tp.num_mixtures) == (6, 3)
    w_out, w_comp = jga.gmm_log_pdf(jp, jnp.asarray(frames), return_components=True)
    g_out, g_comp = tga.gmm_log_pdf(tp, torch.from_numpy(frames), return_components=True)
    _close(g_out, w_out, what="log_pdf")
    _close(g_comp, w_comp, what="components")
    # Leading batch dimensions pass through.
    _close(tga.gmm_log_pdf(tp, torch.from_numpy(np.stack([frames, frames])))[1], w_out)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_gmm_quad_emissions_at_each_tier(precision):
    """The quad layout over the S*K Gaussians (gmm_log_pdf_quad, and the
    decoder's tier emissions on the kernel's padded layout) against JAX's
    whitening GMM emissions."""
    means, covs, weights, frames = _gmm_arrays(1)
    want = jga.gmm_log_pdf(jga.make_gmm_params(*(jnp.asarray(x) for x in
                                                  (means, covs, weights))),
                           jnp.asarray(frames))
    jq = jga.gmm_log_pdf_quad(jga.make_gmm_quad_params(
        *(jnp.asarray(x) for x in (means, covs, weights))), jnp.asarray(frames))
    if precision == "highest":
        got = tga.gmm_log_pdf_quad(tga.make_gmm_quad_params(means, covs, weights,
                                                            device="cpu"),
                                   torch.from_numpy(frames))
        _close(got, jq, rtol=1e-4, atol=1e-2, what="quad vs JAX quad")
        _close(got, want, rtol=1e-4, atol=5e-2, what="quad vs whitening")
    models = [tg.GMMWordHMM(label=f"w{i}", means=means[3 * i: 3 * i + 3],
                            covariances=covs[3 * i: 3 * i + 3],
                            weights=weights[3 * i: 3 * i + 3],
                            log_a=uniform_forward_log_a(3)) for i in range(2)]
    dec = ContinuousDecoder(models, emissions="quad", emission_precision=precision,
                            device="cpu")
    got = dec._log_b(torch.from_numpy(frames)[None])[0]
    assert torch.isfinite(got).all()
    if precision == "default":
        from cs304_tpu.ops.logmath import logsumexp
        from cs304_tpu.ops.pallas import emission as jem

        s, k, d = means.shape
        nhp, lin, const = jem._pack_quad_params(jnp.asarray(means.reshape(s * k, d)),
                                                jnp.asarray(covs.reshape(s * k, d, d)), 128)
        x, bf = jnp.asarray(frames), jnp.bfloat16
        comp = (jem._dot_bf16(jem._build_x2(x).astype(bf), nhp.astype(bf))
                + jem._dot_bf16(x.astype(bf), lin.astype(bf)) + const[0:1])[:, : s * k]
        want = logsumexp(comp.reshape(-1, s, k) + jnp.log(jnp.asarray(weights)), axis=-1)
        _close(got, want, rtol=1e-5, atol=2e-3, what="decoder quad default")
    else:
        _close(got, want, rtol=1e-4, atol=5e-2, what=f"decoder quad {precision}")


def _word_clips(seed, n=5, d=4, s=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(s, d)).astype(np.float32) * 4
    clips = []
    for _ in range(n):
        frames = [centers[i] + rng.normal(0, 0.6, size=(rng.integers(3, 7), d))
                  for i in range(s)]
        clips.append(np.concatenate(frames).astype(np.float32))
    return clips


def _assert_gmm_model(want, got, what=""):
    np.testing.assert_allclose(got.means, want.means, rtol=1e-4, atol=1e-4, err_msg=what)
    np.testing.assert_allclose(got.covariances, want.covariances, rtol=1e-3, atol=1e-4,
                               err_msg=what)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-4, atol=1e-4,
                               err_msg=what)
    _close(got.log_a, want.log_a, rtol=1e-4, atol=1e-4, what=f"log_a {what}")


def test_gmm_trainers_match_jax():
    cfg = dict(num_states=4, max_iterations=6, length_multiple=8, cov_reg=0.01)
    # These clips empty a state in both packages' k-means.
    clips = _word_clips(2, n=8)
    with pytest.raises(jg.HMMTrainMeanFail, match="empty state"):
        jg.train_gmm_hmm("7", clips, num_mixtures=2, cfg=JKCfg(**cfg), seed=3)
    with pytest.raises(tg.HMMTrainMeanFail, match="empty state"):
        tg.train_gmm_hmm("7", clips, num_mixtures=2, cfg=SegmentalKMeansConfig(**cfg),
                         seed=3, device="cpu")
    clips = _word_clips(3, n=8)
    want = jg.train_gmm_hmm("7", clips, num_mixtures=2, cfg=JKCfg(**cfg), seed=3)
    got = tg.train_gmm_hmm("7", clips, num_mixtures=2, cfg=SegmentalKMeansConfig(**cfg),
                           seed=3, device="cpu")
    _assert_gmm_model(want, got, "k-means")
    want_bw = jg.train_gmm_hmm_baum_welch("7", clips, 2, JKCfg(**cfg), init=want)
    got_bw = tg.train_gmm_hmm_baum_welch("7", clips, 2, SegmentalKMeansConfig(**cfg),
                                         init=got, device="cpu")
    _assert_gmm_model(want_bw, got_bw, "baum-welch")
    init = JWordHMM(label="7", means=want.means[:, 0].copy(),
                    covariances=want.covariances[:, 0].copy(), log_a=want.log_a.copy())
    w1 = jg.train_word_hmm_baum_welch("7", clips, JKCfg(**cfg), init=init)
    g1 = tg.train_word_hmm_baum_welch(
        "7", clips, SegmentalKMeansConfig(**cfg),
        init=WordHMM(label="7", means=init.means, covariances=init.covariances,
                     log_a=init.log_a), device="cpu")
    assert isinstance(g1, WordHMM)
    np.testing.assert_allclose(g1.means, w1.means, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g1.covariances, w1.covariances, rtol=1e-3, atol=1e-4)
    _close(g1.log_a, w1.log_a, rtol=1e-4, atol=1e-4)


def test_gmm_word_model_scores_match_jax():
    means, covs, weights, frames = _gmm_arrays(4, s=4, k=2, d=5, pad_last=False)
    log_a = uniform_forward_log_a(4)
    jm = jg.GMMWordHMM("3", means, covs, weights, log_a)
    tm = tg.GMMWordHMM("3", means, covs, weights, log_a)
    _close(tm.log_likelihoods(frames, device="cpu"), jm.log_likelihoods(frames))
    ws, wp = jm.predict(frames, length=20)
    gs, gp = tm.predict(frames, length=20, device="cpu")
    _close(gs, ws, what="score")
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(tm.forward_score(frames, device="cpu"),
                               jm.forward_score(frames), rtol=1e-5)


def _mixed_models(seed, d=4):
    rng = np.random.default_rng(seed)
    out = {}
    for i, lab in enumerate(("1", "2", "S")):
        s = 3 if lab == "S" else 4
        a = rng.normal(size=(s, d, 2)).astype(np.float32)
        covs = a @ a.transpose(0, 2, 1) + np.eye(d, dtype=np.float32)
        means = rng.normal(size=(s, d)).astype(np.float32)
        if lab == "2":
            k = 3
            out[lab] = tg.GMMWordHMM(lab, np.repeat(means[:, None], k, 1) + 0.1,
                                     np.repeat(covs[:, None], k, 1),
                                     np.full((s, k), 1 / k, np.float32),
                                     uniform_forward_log_a(s))
        else:
            out[lab] = WordHMM(lab, means, covs, uniform_forward_log_a(s))
    return out


def _to_jax(m):
    if isinstance(m, tg.GMMWordHMM):
        return jg.GMMWordHMM(m.label, m.means, m.covariances, m.weights, m.log_a)
    return JWordHMM(m.label, m.means, m.covariances, m.log_a)


def test_stacking_lift_and_padding_bitwise():
    models = _mixed_models(5)
    for m in models.values():
        for w, g in zip(jg.pad_mixture_params(_to_jax(m), 4), tg.pad_mixture_params(m, 4)):
            np.testing.assert_array_equal(w, g)
    want = j_stack_models({k: _to_jax(v) for k, v in models.items()})
    got = stack_models(models)
    assert want.is_gmm and got.is_gmm
    for name in ("means", "covariances", "weights", "log_a"):
        np.testing.assert_array_equal(getattr(want, name), getattr(got, name), err_msg=name)
    w, g = want.sentence_for("21", True), got.sentence_for("21", True)
    assert w[0] == g[0]
    for a, b in zip((w[2], *w[3]), (g[2], *g[3])):
        np.testing.assert_array_equal(a, b)
    single = {k: v for k, v in models.items() if k != "2"}
    assert not stack_models(single).is_gmm and stack_models(single).weights is None
