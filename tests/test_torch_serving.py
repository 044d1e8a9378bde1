"""The port's ServingSessionPool (cs304_tpu_torch/serving.py, device="cpu")
against the JAX package's on the same audio: finals, num_samples,
last_partial and the partials polled after every feed() are equal, through
multi-utterance sessions, two utterances in one feed, pool exhaustion, ring
overflow, a silence-only session, and partials off and "exact". The models
are the port's flagship_models() carried to JAX by numpy (parity needs no
accuracy); the audio is the synthetic corpus's sentences over 20-amplitude
noise, made with numpy from seeds.
"""
import numpy as np
import pytest
import torch

from cs304_tpu.models.hmm import WordHMM as JaxWordHMM
from cs304_tpu.serving import ServingSessionPool as JaxServingSessionPool
from cs304_tpu_torch.data.synthetic import SyntheticTIDigits
from cs304_tpu_torch.models.hmm import flagship_models
from cs304_tpu_torch.serving import ServingSessionPool
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

SR = 16000
MODELS = flagship_models()
JAX_MODELS = {m.label: JaxWordHMM(m.label, m.means, m.covariances, m.log_a) for m in MODELS}


@pytest.fixture(scope="module")
def corpus():
    return SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1,
                             takes_per_digit=1, with_sentences=True)


def _silence(seconds, seed):
    return np.random.default_rng(seed).normal(0, 20.0, int(seconds * SR)).astype(np.float32)


def _session_audio(corpus, transcripts, speaker, gap=0.5):
    pieces = [_silence(0.3, speaker)]
    for i, tr in enumerate(transcripts):
        pieces.append(corpus.sentence_audio(tr, speaker, jitter_seed=i))
        pieces.append(_silence(gap, speaker * 7 + i))
    return np.concatenate(pieces)


def _drain(pool, audio_by_session, chunk=1600, poll=True):
    """Feed every session its audio in chunk-size pieces, polling partials
    after each feed(); returns (results, partials per feed)."""
    sessions = [pool.open() for _ in audio_by_session]
    results = {s: [] for s in sessions}
    polls = []
    longest = max(len(a) for a in audio_by_session)
    for off in range(0, longest, chunk):
        done = pool.feed({s: a[off: off + chunk]
                          for s, a in zip(sessions, audio_by_session) if off < len(a)})
        for s, rs in done.items():
            results[s] += [(r.text, r.num_samples, r.last_partial) for r in rs]
        if poll:
            polls.append(pool.partials(sessions))
    return [results[s] for s in sessions], polls


def _both(audio_by_session, chunk=1600, poll=True, **kw):
    want = _drain(JaxServingSessionPool(JAX_MODELS, **kw), audio_by_session, chunk, poll)
    got = _drain(ServingSessionPool(MODELS, device="cpu", **kw), audio_by_session, chunk, poll)
    return want, got


def test_multi_utterance_sessions_match_jax(corpus):
    audio = [_session_audio(corpus, ["37", "12"], speaker=0),
             _session_audio(corpus, ["5"], speaker=1)]
    want, got = _both(audio, num_slots=4)
    assert [len(r) for r in want[0]] == [2, 1]
    assert got == want
    assert any(p for poll in got[1] for p in poll.values()), "partials while speaking"


def test_two_utterances_in_one_feed_and_pool_exhaustion_match_jax(corpus):
    """Everything in ONE feed() whose length is not a frame multiple, then
    the rest: with 4 slots, and with ONE slot (the successor utterance's
    partials start late instead of feed() raising)."""
    audio = _session_audio(corpus, ["37", "12"], speaker=0)
    for slots in (4, 1):
        runs = []
        for pool in (JaxServingSessionPool(JAX_MODELS, num_slots=slots),
                     ServingSessionPool(MODELS, num_slots=slots, device="cpu")):
            s = pool.open()
            done = pool.feed({s: audio[: len(audio) - 13]})
            out = [(r.text, r.num_samples, r.last_partial) for r in done.get(s, [])]
            done = pool.feed({s: np.concatenate([audio[len(audio) - 13:], _silence(0.5, 9)])})
            out += [(r.text, r.num_samples, r.last_partial) for r in done.get(s, [])]
            runs.append(out)
        assert len(runs[0]) == 2 and runs[1] == runs[0], slots


def test_ring_overflow_and_silence_only_match_jax(corpus):
    """max_frames=48 (every sentence overflows the ring: finals only for
    that utterance), and a session that never speaks."""
    audio = [_session_audio(corpus, ["37"], speaker=0), _silence(1.0, 3)]
    want, got = _both(audio, num_slots=2, max_frames=48)
    assert got == want
    results, polls = got
    assert len(results[0]) == 1 and results[1] == []
    assert all(poll[1] == "" for poll in polls)


def test_partials_off_and_exact_match_jax(corpus):
    audio = [_session_audio(corpus, ["37"], speaker=1)]
    for mode in (False, "exact"):
        want, got = _both(audio, num_slots=2, partials=mode)
        assert got == want, mode
        results, polls = got
        assert len(results[0]) == 1
        if mode is False:
            assert results[0][0][2] == "" and all(p[0] == "" for p in polls)


def test_unported_options_and_no_card_raise(monkeypatch):
    # mesh= takes a data-parallel mesh (tests/test_torch_parallel.py serves
    # over one), not any object; confidences=True and bigram= raised
    # before the search slice and now serve (test_torch_serving_search.py
    # holds them against JAX's pool), but not together, as in JAX.
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServingSessionPool(MODELS, num_slots=2, device="cpu", mesh=object())
    from cs304_tpu_torch.ops.lm import train_word_bigram

    bigram = train_word_bigram(["12", "37"], sorted(m.label for m in MODELS))
    for kw in ({"confidences": True}, {"bigram": bigram}):
        pool = ServingSessionPool(MODELS, num_slots=2, device="cpu", **kw)
        pool.close(pool.open())
    with pytest.raises(ValueError, match="cannot combine"):
        ServingSessionPool(MODELS, num_slots=2, device="cpu", confidences=True,
                           bigram=bigram)
    with pytest.raises(ValueError, match="partials"):
        ServingSessionPool(MODELS, partials="sometimes", device="cpu")
    pool = ServingSessionPool(MODELS, num_slots=2, device="cpu")
    s = pool.open()
    pool.close(s)
    with pytest.raises(KeyError):
        pool.feed({s: _silence(0.1, 0)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingSessionPool(MODELS, num_slots=2)
