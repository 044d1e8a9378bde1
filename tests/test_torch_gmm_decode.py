"""GMM decoding in the port against the JAX package on the CPU: the
ContinuousDecoder on all-GMM and mixed Gaussian / GMM model sets
(predict_batch, viterbi_batch and predict_signal_batch), GMM checkpoints
saved by either package and loaded by the other, the GMM StreamingComposite
and BatchedStreamingComposite (dense and banded steps), and a 2-session
ServingSessionPool on GMM models.

Models are the flagship's (12 words, D = 39) promoted to K = 2 by
promote_to_gmm; features are drawn from their state Gaussians along random
word sequences (test_torch_decoder.py). Emissions differ from JAX only in
float32 summation order: transcripts and paths must be identical and scores
agree to rtol 1e-4 (1e-5 for the streaming pools, as
test_torch_streaming.py holds them).
"""
import numpy as np
import pytest
import torch

from cs304_tpu.models.decoder import ContinuousDecoder as JDecoder
from cs304_tpu.models.gmm_hmm import GMMWordHMM as JGMMWordHMM
from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu.ops.streaming import StreamingComposite as JStreaming
from cs304_tpu.ops.streaming_batch import BatchedStreamingComposite as JPool
from cs304_tpu.serving import ServingSessionPool as JServing
from cs304_tpu.utils import checkpoint as jck
from cs304_tpu_torch.data.batching import make_signals
from cs304_tpu_torch.data.synthetic import SyntheticTIDigits
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.gmm_hmm import GMMWordHMM
from cs304_tpu_torch.models.hmm import flagship_models, from_numpy_models
from cs304_tpu_torch.models.train_continuous_gmm import promote_to_gmm
from cs304_tpu_torch.ops.streaming import StreamingComposite
from cs304_tpu_torch.ops.streaming_batch import BatchedStreamingComposite
from cs304_tpu_torch.serving import ServingSessionPool
from cs304_tpu_torch.utils import checkpoint as tck
from test_torch_decoder import _sampled_features
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _gmm_models(mixed=False):
    base = {m.label: m for m in flagship_models()}
    gmm = promote_to_gmm(base, 2, jitter=0.3, seed=1)
    if mixed:  # every other word stays a single Gaussian
        for i, label in enumerate(sorted(base)):
            if i % 2:
                gmm[label] = base[label]
    return gmm


def _to_jax(models):
    out = {}
    for label, m in models.items():
        if isinstance(m, GMMWordHMM):
            out[label] = JGMMWordHMM(label, m.means, m.covariances, m.weights, m.log_a)
        else:
            out[label] = JWordHMM(label, m.means, m.covariances, m.log_a)
    return out


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("emissions", ["whiten", "quad"])
def test_gmm_decoder_matches_jax(mixed, emissions):
    models = _gmm_models(mixed)
    feats = _sampled_features(5, 6) + [np.zeros((140, 39), np.float32)]
    # JAX's "fast" backend is bitwise its scan-free kernels (interpret mode
    # on the CPU costs seconds a shape).
    jdec = JDecoder(_to_jax(models), penalty=-100.0, backend="fast", emissions=emissions)
    tdec = ContinuousDecoder(models, penalty=-100.0, emissions=emissions, device="cpu")
    want = jdec.predict_batch(feats)
    assert tdec.predict_batch(feats) == want
    assert any(len(w) > 1 for w in want)
    js, jp, jl = jdec.viterbi_batch(feats)
    ts, tp, tl = tdec.viterbi_batch(feats)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, rtol=1e-4)
    for i, n in enumerate(tl):
        np.testing.assert_array_equal(tp[i, :n], jp[i, :n])
    # The other trellis backends read the same GMM emissions.
    for backend in (("scanfree", "scan", "pallas") if mixed else ()):
        dec = ContinuousDecoder(models, penalty=-100.0, emissions=emissions,
                                backend=backend, device="cpu")
        assert dec.predict_batch(feats) == want, backend


def test_gmm_predict_signal_batch_matches_jax():
    """predict_signal_batch scores GMMs with the whitening layout whatever
    emissions says, as the JAX decoder does."""
    sig = list(make_signals(3, 1.0, seed=3)) + list(make_signals(2, 0.7, seed=4))
    models = _gmm_models(mixed=True)
    want = JDecoder(_to_jax(models), penalty=-100.0, backend="fast",
                    emissions="quad").predict_signal_batch(sig)
    for emissions in ("quad", "whiten"):
        dec = ContinuousDecoder(models, penalty=-100.0, emissions=emissions, device="cpu")
        assert dec.predict_signal_batch(sig) == want, emissions


def test_gmm_checkpoints_round_trip_both_ways(tmp_path):
    models = _gmm_models(mixed=True)
    tck.save_models(models, str(tmp_path / "port"), tier="words")
    jloaded = jck.load_models(str(tmp_path / "port"))
    jck.save_models(_to_jax(models), str(tmp_path / "jax"))
    tloaded = tck.load_models(str(tmp_path / "jax"))
    for label, m in models.items():
        for loaded in (jloaded[label], tloaded[label]):
            assert (getattr(loaded, "weights", None) is None) == (
                getattr(m, "weights", None) is None)
            for name in ("means", "covariances", "log_a") + (
                    ("weights",) if isinstance(m, GMMWordHMM) else ()):
                np.testing.assert_array_equal(getattr(loaded, name), getattr(m, name))
        assert isinstance(tloaded[label], GMMWordHMM) == isinstance(m, GMMWordHMM)
    feats = _sampled_features(7, 4)
    want = JDecoder(jloaded, penalty=-100.0).predict_batch(feats)
    assert ContinuousDecoder(tloaded, penalty=-100.0, device="cpu").predict_batch(feats) == want
    # from_numpy_models carries GMM parameters across as well.
    gmm = [m for m in models.values() if isinstance(m, GMMWordHMM)]
    again = from_numpy_models([m.label for m in gmm], [m.means for m in gmm],
                              [m.covariances for m in gmm], [m.log_a for m in gmm],
                              weights=[m.weights for m in gmm])
    assert all(isinstance(m, GMMWordHMM) for m in again)
    np.testing.assert_array_equal(again[0].weights, gmm[0].weights)


def _chunks(x, sizes):
    out, at = [], 0
    for n in sizes:
        out.append(x[at: at + n])
        at += n
    return out


def test_gmm_streaming_composite_matches_jax():
    models = _gmm_models(mixed=True)
    feats = _sampled_features(9, 1, min_words=3, max_words=3)[0]
    js = JStreaming.from_models(_to_jax(models), penalty=-100.0, chunk_size=16)
    ts = StreamingComposite.from_models(models, penalty=-100.0, chunk_size=16, device="cpu")
    for chunk in _chunks(feats, [10, 16, 3, 40]):
        js.feed(chunk)
        ts.feed(chunk)
        assert ts.partial_labels() == js.partial_labels()
    (w_score, w_path), (g_score, g_path) = js.finalize(), ts.finalize()
    np.testing.assert_array_equal(g_path, np.asarray(w_path))
    np.testing.assert_allclose(g_score, w_score, rtol=1e-5)


@pytest.mark.parametrize("step_impl", ["dense", "banded"])
def test_gmm_pool_matches_jax(step_impl):
    models = _gmm_models(mixed=False)
    utts = _sampled_features(11, 3, min_words=2, max_words=3)
    kw = dict(penalty=-100.0, num_slots=4, chunk_size=16, max_frames=256,
              step_impl=step_impl)
    jq = JPool.from_models(_to_jax(models), **kw)
    tq = BatchedStreamingComposite.from_models(models, device="cpu", **kw)
    assert tq.step_impl == jq.step_impl == step_impl
    js, ts = [jq.start() for _ in utts], [tq.start() for _ in utts]
    longest = max(len(u) for u in utts)
    for lo in range(0, longest, 16):
        feeds_j = {s: u[lo: lo + 16] for s, u in zip(js, utts) if lo < len(u)}
        feeds_t = {s: u[lo: lo + 16] for s, u in zip(ts, utts) if lo < len(u)}
        jq.step(feeds_j)
        tq.step(feeds_t)
        assert tq.partial_texts(ts) == {t: v for t, v in zip(
            ts, jq.partial_texts(js).values())}
    want, got = jq.finalize(js), tq.finalize(ts)
    for j, t in zip(js, ts):
        assert got[t][1] == want[j][1]
        np.testing.assert_allclose(got[t][0], want[j][0], rtol=1e-5)
    with pytest.raises(ValueError, match="quad"):
        BatchedStreamingComposite.from_models(models, device="cpu", emissions="quad",
                                              step_impl="banded")


def test_gmm_serving_pool_matches_jax():
    corpus = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1,
                               takes_per_digit=1, with_sentences=True)
    rng = np.random.default_rng(0)

    def silence(seconds):
        return rng.normal(0, 20.0, int(seconds * 16000)).astype(np.float32)

    audio = [np.concatenate([silence(0.3), corpus.sentence_audio(tr, spk, jitter_seed=0),
                             silence(0.5)]) for tr, spk in (("37", 0), ("5", 1))]
    models = _gmm_models(mixed=False)
    runs = []
    for pool in (JServing(_to_jax(models), num_slots=2),
                 ServingSessionPool(models, num_slots=2, device="cpu")):
        sessions = [pool.open() for _ in audio]
        out, polls = {s: [] for s in sessions}, []
        for off in range(0, max(len(a) for a in audio), 1600):
            done = pool.feed({s: a[off: off + 1600]
                              for s, a in zip(sessions, audio) if off < len(a)})
            for s, rs in done.items():
                out[s] += [(r.text, r.num_samples, r.last_partial) for r in rs]
            polls.append(list(pool.partials(sessions).values()))
        runs.append(([out[s] for s in sessions], polls))
    assert runs[1] == runs[0]
    assert all(len(r) == 1 for r in runs[0][0])
