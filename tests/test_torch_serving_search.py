"""Search in the port's serving front end against the JAX package on the
CPU: ServingSessionPool(confidences=True) and ServingSessionPool(bigram=)
fed the same audio as JAX's pool (finals, num_samples, last partials and
polled partials equal; confidences within rtol 2e-4, each package scoring
its own emissions, and a log posterior is a difference of float32 sums of
magnitude |log Z|);
and the bigram BatchedStreamingComposite (the plain version of the LM stream
mode) giving the offline ContinuousDecoder(bigram=)'s transcripts, and the
JAX bigram pool's scores and texts, on the same features."""
import numpy as np

from cs304_tpu.ops import lm as jlm
from cs304_tpu.ops import streaming_batch as jsb
from cs304_tpu.serving import ServingSessionPool as JServing
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.models.hmm import flagship_models
from cs304_tpu_torch.ops import lm as tlm
from cs304_tpu_torch.ops import streaming_batch as tsb
from cs304_tpu_torch.serving import ServingSessionPool
from test_torch_decoder import _jax_models, _sampled_features
from test_torch_serving import JAX_MODELS, MODELS, _session_audio, corpus  # noqa: F401
from test_torch_bigram_beam import one_torch_thread  # noqa: F401

LABELS = sorted(m.label for m in MODELS)
LM_CORPUS = ["37", "12", "5", "375", "4Z", "9O2", "186Z", "54321", "12", "37"]


def _drain(pool, audio_by_session, chunk=1600):
    sessions = [pool.open() for _ in audio_by_session]
    results = {s: [] for s in sessions}
    polls = []
    for off in range(0, max(len(a) for a in audio_by_session), chunk):
        done = pool.feed({s: a[off: off + chunk]
                          for s, a in zip(sessions, audio_by_session) if off < len(a)})
        for s, rs in done.items():
            results[s] += [(r.text, r.num_samples, r.last_partial, r.confidence) for r in rs]
        polls.append(pool.partials(sessions))
    return [results[s] for s in sessions], polls


def test_serving_with_confidences_matches_jax(corpus):  # noqa: F811
    audio = [_session_audio(corpus, ["37", "12"], speaker=0),
             _session_audio(corpus, ["5"], speaker=1)]
    want = _drain(JServing(JAX_MODELS, num_slots=4, confidences=True), audio)
    got = _drain(ServingSessionPool(MODELS, num_slots=4, confidences=True, device="cpu"),
                 audio)
    assert got[1] == want[1]
    assert [[r[:3] for r in rs] for rs in got[0]] == [[r[:3] for r in rs] for rs in want[0]]
    confs = [(g[3], w[3]) for gs, ws in zip(got[0], want[0]) for g, w in zip(gs, ws)]
    assert len(confs) == 3 and all(0.0 <= g <= 1.0 for g, _w in confs)
    np.testing.assert_allclose([g for g, _w in confs], [w for _g, w in confs],
                               rtol=2e-4, atol=1e-6)


def test_serving_with_bigram_matches_jax(corpus):  # noqa: F811
    audio = [_session_audio(corpus, ["37", "12"], speaker=0),
             _session_audio(corpus, ["5"], speaker=1)]
    want = _drain(JServing(JAX_MODELS, num_slots=4, lm_weight=3.0,
                           bigram=jlm.train_word_bigram(LM_CORPUS, LABELS)), audio)
    pool = ServingSessionPool(MODELS, num_slots=4, lm_weight=3.0, device="cpu",
                              bigram=tlm.train_word_bigram(LM_CORPUS, LABELS))
    assert pool._pool.step_impl == "banded" and pool._pool._lm is not None
    got = _drain(pool, audio)
    assert got == want
    assert all(r[3] is None for rs in got[0] for r in rs)


def test_bigram_pool_finals_equal_offline_bigram_decode():
    feats = _sampled_features(51, 6, min_words=2, max_words=4)
    bg_t, bg_j = tlm.train_word_bigram(LM_CORPUS, LABELS), jlm.train_word_bigram(LM_CORPUS,
                                                                                 LABELS)
    kw = dict(penalty=-100.0, num_slots=8, chunk_size=16, max_frames=256, lm_weight=2.0)
    tpool = tsb.BatchedStreamingComposite.from_models(flagship_models(), bigram=bg_t,
                                                      device="cpu", **kw)
    jpool = jsb.BatchedStreamingComposite.from_models(_jax_models(), bigram=bg_j, **kw)
    lm_dec = ContinuousDecoder(flagship_models(), penalty=-100.0, bigram=bg_t,
                               lm_weight=2.0, device="cpu")
    offline = lm_dec.predict_batch(feats)
    flat = ContinuousDecoder(flagship_models(), penalty=-100.0, device="cpu")
    t_slots = [tpool.start() for _ in feats]
    j_slots = [jpool.start() for _ in feats]
    for lo in range(0, max(len(f) for f in feats), 16):
        tpool.step({s: f[lo: lo + 16] for s, f in zip(t_slots, feats) if lo < len(f)})
        jpool.step({s: f[lo: lo + 16] for s, f in zip(j_slots, feats) if lo < len(f)})
    got, want = tpool.finalize(t_slots), jpool.finalize(j_slots)
    assert [got[s][1] for s in t_slots] == offline
    assert [got[s][1] for s in t_slots] == [want[s][1] for s in j_slots]
    np.testing.assert_allclose([got[s][0] for s in t_slots], [want[s][0] for s in j_slots],
                               rtol=1e-5)
    # The LM is in effect: its scores are not the flat decode's.
    assert not np.array_equal(lm_dec.viterbi_batch(feats)[0], flat.viterbi_batch(feats)[0])
