"""The port's streaming endpointer against the JAX package's, bitwise.

cs304_tpu_torch/native is a copy of the JAX package's native tier, built
at first use into cs304_tpu_torch/_build/; its Python fallbacks are the
documented twins. Both paths of the port's native_endpoint_feed, and the
port's Segmentation (feed_frames, routine, result_signal), must give the
JAX package's events, labels, states and captured samples, with state
carried across calls and endpoints falling mid-chunk.
"""
import numpy as np
import pytest

from cs304_tpu.audio.capture import Segmentation as JaxSegmentation
from cs304_tpu.audio.capture import SegmentationDone as JaxDone
from cs304_tpu.native import loader as jax_loader
from cs304_tpu_torch import native
from cs304_tpu_torch.audio.capture import Segmentation, SegmentationDone
from cs304_tpu_torch.native import build as native_build
from cs304_tpu_torch.native import loader

FS = 320
SR = 16000


def _audio(seed):
    """Loud and quiet stretches of random lengths (quiet ones of 0.1-1 s, so
    some end a take and some do not), amplitudes crossing both thresholds."""
    r = np.random.default_rng(seed)
    return np.concatenate([
        r.normal(0, r.uniform(700, 1000) if i % 2 else r.uniform(5, 60),
                 int(r.uniform(0.1, 1.0) * SR)).astype(np.float32)
        for i in range(16)
    ])


def _feed_frames(seg_cls, audio, chunk_seed):
    """Random whole-frame chunks; an endpoint re-feeds the chunk's rest to a
    fresh machine. Returns (events, (done, consumed) per call, the last
    machine)."""
    seg = seg_cls(stream=None, silence_duration_threshold=0.2)
    events, consumed_log = [], []
    r = np.random.default_rng(chunk_seed)
    n = len(audio) // FS
    off = 0
    while off < n * FS:
        chunk = audio[off: min(off + int(r.integers(1, 12)) * FS, n * FS)]
        off += len(chunk)
        coff = 0
        while coff < len(chunk):
            done, consumed = seg.feed_frames(chunk[coff:])
            consumed_log.append((done, consumed))
            coff += consumed
            if done:
                events.append(seg.result_signal().tobytes())
                seg = seg_cls(stream=None, silence_duration_threshold=0.2)
    return events, consumed_log, seg


def _state(seg):
    kept = (np.concatenate([np.asarray(f).reshape(-1) for f in seg._results])
            if seg._results else np.zeros(0, np.float32))
    return (seg._end_counter._counter, seg._between, seg._ever_high, kept.tobytes())


@pytest.mark.parametrize("seed", range(3))
def test_feed_frames_is_jax_native_and_python(seed, monkeypatch):
    audio = _audio(seed)
    want = _feed_frames(JaxSegmentation, audio, 100 + seed)
    assert want[0], "the audio must hold endpoints"
    got = _feed_frames(Segmentation, audio, 100 + seed)
    assert got[:2] == want[:2] and _state(got[2]) == _state(want[2])
    monkeypatch.setattr(loader, "_load", lambda: None)  # the Python twin
    got_py = _feed_frames(Segmentation, audio, 100 + seed)
    assert got_py[:2] == want[:2] and _state(got_py[2]) == _state(want[2])


def test_native_endpoint_feed_state_and_labels_are_jax(monkeypatch):
    """native_endpoint_feed directly: state carried across calls, labels and
    done counts equal to JAX's native call, for both of the port's paths."""
    audio = _audio(7)
    n = len(audio) // FS
    for python_path in (False, True):
        if python_path:
            monkeypatch.setattr(loader, "_load", lambda: None)
        ours, theirs = np.zeros(3, np.int32), np.zeros(3, np.int32)
        off = 0
        r = np.random.default_rng(1)
        while off < n:
            k = min(int(r.integers(1, 40)), n - off)
            chunk = audio[off * FS: (off + k) * FS]
            got = native.native_endpoint_feed(ours, chunk, FS, 512.0, 64.0, 10)
            want = jax_loader.native_endpoint_feed(theirs, chunk, FS, 512.0, 64.0, 10)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(ours, theirs)
            off += got[0] if got[0] else k
            if got[0]:
                ours[:] = 0
                theirs[:] = 0


def test_routine_and_feed_frames_interleave_as_jax():
    """routine() per frame, feed_frames per chunk, alternating on one machine,
    with endpoints: the same events and captured samples as JAX's."""
    audio = _audio(5)
    n = len(audio) // FS

    def drive(seg_cls, done_exc):
        seg = seg_cls(stream=None, silence_duration_threshold=0.2)
        events = []
        i = 0
        while i < n:
            if (i // 4) % 2 == 0:
                seg.audio_cache.put(audio[i * FS: (i + 1) * FS])
                i += 1
                try:
                    seg.routine()
                except done_exc:
                    events.append(seg.result_signal().tobytes())
                    seg = seg_cls(stream=None, silence_duration_threshold=0.2)
            else:
                chunk = audio[i * FS: min(i + 4, n) * FS]
                done, consumed = seg.feed_frames(chunk)
                i += consumed // FS
                if done:
                    events.append(seg.result_signal().tobytes())
                    seg = seg_cls(stream=None, silence_duration_threshold=0.2)
        return events, _state(seg)

    assert drive(Segmentation, SegmentationDone) == drive(JaxSegmentation, JaxDone)
    with pytest.raises(ValueError, match="whole 320-sample frames"):
        Segmentation(stream=None).feed_frames(np.zeros(FS + 1, np.float32))


def test_native_library_builds_at_first_use_into_the_build_dir(tmp_path):
    """The library lands in cs304_tpu_torch/_build/ under a source-hash name
    (never beside the source), HAS_NATIVE reports the path taken, and the
    other entry points agree with JAX's."""
    assert native_build.BUILD_DIR.name == "_build"
    assert native_build.library_path().parent == native_build.BUILD_DIR
    assert not list(native_build.SOURCE.parent.glob("*.so"))
    assert native.HAS_NATIVE == loader.has_native() == (loader._load() is not None)
    audio = _audio(2)[: 50 * FS + 77]
    np.testing.assert_array_equal(native.native_frame_energies(audio, FS),
                                  jax_loader.native_frame_energies(audio, FS))
    energies = jax_loader.native_frame_energies(audio, FS)
    got = native.native_endpoint_frames(energies, 300.0, 50.0, 5)
    want = jax_loader.native_endpoint_frames(energies, 300.0, 50.0, 5)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    from cs304_tpu_torch.audio.wav import write_wav_int16

    path = str(tmp_path / "a.wav")
    write_wav_int16(path, audio, SR)
    rate, sig = native.native_read_wav(path)
    rate_j, sig_j = jax_loader.native_read_wav(path)
    assert rate == rate_j == SR
    np.testing.assert_array_equal(sig, sig_j)
