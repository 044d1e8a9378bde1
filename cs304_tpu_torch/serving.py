"""Raw-audio serving sessions: endpointing + online decoding at scale.

The reference's live loop serves ONE microphone: block on the endpointer,
then decode the finished utterance (scripts/project6_interactive.py:16-39
there). This layer scales that to many concurrent audio sessions:

- per session, the reference's energy-hysteresis endpointer
  (audio/capture.py Segmentation — the same thresholds/state machine) runs
  incrementally over the fed samples;
- during speech, frames stream through a causal MFCC front-end
  (ops/streaming_mfcc.py, dB reference calibrated from the utterance's first
  ~0.2 s of speech) into the batched online decoder
  (ops/streaming_batch.py) — so `partial(session)` returns a live
  hypothesis while the user is still talking;
- at the endpoint, the finished utterance is re-featurized OFFLINE
  (bit-parity features, utterance-global dB reference) and decoded through
  the batch decoder — finals are exactly what project6_interactive would
  print for the same endpointed audio. Finals finishing in the same
  `feed()` call are decoded as ONE batch.

Partials are approximate by construction (causal dB reference); finals are
parity-exact. Sessions recycle their decode slots between utterances, so a
session can carry any number of utterances (speak, pause, speak, ...).

The port of the JAX package's serving.py. The endpointer and the causal
front end are host code (native/, ops/streaming_mfcc.py); on the card the
pool's step is K4 at <= 127 states (the stream mode of the scan-free team
kernel past that), its finalize K2-bt on the ring, and the finals the
decoder's whitening emissions, then scanfree_decode, then words. GMM and
mixed model sets serve through the same path: the pool and the decoder
both lift them (K-mixture whitening emissions before the same steps).
With bigram= the pool's step is the LM variant of the stream mode and the
finals the decoder's LM decode mode; with confidences=True the finals are
the dense decode (K4 + K2-bt) with posterior confidences (ops/lattice.py:
the LSUM kernel).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .audio.capture import Segmentation
from .models.decoder import ContinuousDecoder
from .ops.mfcc import MFCCConfig, mfcc_batch
from .ops.streaming_batch import BatchedStreamingComposite
from .ops.streaming_mfcc import StreamingMFCC, mel_peak

logger = logging.getLogger(__name__)

@dataclass(frozen=True)
class UtteranceResult:
    session: int
    text: str  # offline-parity decode of the endpointed utterance
    num_samples: int  # endpointed utterance length (trailing silence trimmed)
    # The streaming hypothesis at the endpoint ("" with partials off).
    # Approximate by construction (causal dB reference vs the offline
    # utterance-global one) — the stream holds back the endpointer's
    # trailing-trim window and terminates best-exit at the endpoint, which
    # in practice makes it match `text`; `text` remains the contract.
    last_partial: str
    confidence: Optional[float] = None  # min per-word posterior (if enabled)


class ServingSessionPool:
    """Many concurrent raw-audio sessions on one card (or a mesh of them).

    >>> pool = ServingSessionPool(models)
    >>> a, b = pool.open(), pool.open()
    >>> done = pool.feed({a: mic_a_chunk, b: mic_b_chunk})  # repeatedly
    >>> pool.partial(a)          # live hypothesis while a speaks
    >>> for r in done.get(a, []): print(r.text)             # finished takes
    """

    # Upgrade the causal dB reference (and replay the utterance so far) when
    # new audio's mel peak exceeds it by this factor (~+6 dB): rare enough
    # to cost at most a couple of extra pool steps per utterance.
    RECALIBRATION_RATIO = 4.0

    def __init__(
        self,
        models,
        penalty: float = -100.0,
        num_slots: int = 64,
        mcfg: MFCCConfig = MFCCConfig(),
        partials: bool | str = True,
        speech_high_threshold: float = 512.0,
        speech_low_threshold: float = 64.0,
        silence_duration_threshold: float = 0.2,
        calibration_seconds: float = 0.2,
        max_frames: int = 4096,
        mesh=None,
        confidences: bool = False,
        bigram=None,
        lm_weight: float = 1.0,
        device=None,
    ) -> None:
        """partials: False disables streaming entirely; "exact" makes every
        partials() poll reflect all audio fed so far (each poll right
        after a feed() waits for that round's device work); True (default)
        = "pipelined": polls serve the previous round's pre-dispatched
        hypotheses — at most one feed() chunk (~100 ms of audio) stale,
        never crossing an utterance boundary, and waiting only for the
        previous round's readback. Endpoint finals and last_partial are
        exact in every mode.

        device: None means the card (raising without one); tests pass "cpu".
        models may be GMMWordHMMs, or a mix with single Gaussians.

        confidences=True scores every final with the minimum per-word
        posterior of ContinuousDecoder.predict_batch_with_confidence (the
        dense decode, K4 + K2-bt on the card, and the sum-semiring passes of
        ops/lattice.py, the LSUM kernel) on host-MFCC features. bigram (+ lm_weight): finals
        and partials decode under the bigram's per-pair penalties (the
        decoder's LM decode mode, the pool's LM stream mode). The two do
        not combine (ValueError): the posterior pass decodes the
        flat-penalty measure.

        mesh: optional data-parallel mesh (parallel/data_parallel.make_mesh)
        over which the streaming pool's slots shard (num_slots must divide
        over the ranks). Every rank makes the same calls with the same
        audio; the finals' decoder runs replicated on each rank's mesh
        device, which an explicit device= must name."""
        if partials not in (True, False, "exact", "pipelined"):
            raise ValueError(f"unknown partials mode {partials!r}")
        self._partials_exact = partials == "exact"
        if bigram is not None and confidences:
            raise ValueError(
                "bigram and confidences cannot combine: confidence finals "
                "decode the flat-penalty posterior measure, which would "
                "silently drop the LM from final texts"
            )
        if mesh is not None:
            from .parallel.data_parallel import site_device

            device = site_device(mesh, device)
        self._confidences = confidences
        self._decoder = ContinuousDecoder(
            models, penalty=penalty, bigram=bigram, lm_weight=lm_weight, device=device
        )
        self._mcfg = mcfg
        self._partials_enabled = partials and mcfg.normalization == "per_frame"
        if partials and not self._partials_enabled:
            logger.info(
                "partials disabled: normalization=%s is utterance-global",
                mcfg.normalization,
            )
        self._pool = (
            BatchedStreamingComposite.from_models(
                models, penalty=penalty, num_slots=num_slots,
                chunk_size=32, max_frames=max_frames, bigram=bigram,
                lm_weight=lm_weight, mesh=mesh, device=device,
            )
            if self._partials_enabled else None
        )
        self._seg_kwargs = dict(
            speech_high_threshold=speech_high_threshold,
            speech_low_threshold=speech_low_threshold,
            silence_duration_threshold=silence_duration_threshold,
            sample_rate=int(mcfg.sample_rate),
        )
        self._calibration_samples = int(
            calibration_seconds * mcfg.sample_rate
        )
        self._sessions: Dict[int, dict] = {}
        self._next_id = 0
        # Set on the first partials() poll: from then on every feed() round
        # pre-dispatches the partial hypotheses (step-fused, async readback)
        # instead of letting each poll pay a blocking full-pool sync.
        self._polls_partials = False

    # -- lifecycle ------------------------------------------------------------
    def open(self) -> int:
        sid = self._next_id
        self._next_id += 1
        self._sessions[sid] = self._fresh_state()
        return sid

    def close(self, session: int) -> None:
        state = self._sessions.pop(session)
        if state["slot"] is not None:
            self._pool.release(state["slot"])

    def _fresh_state(self) -> dict:
        return {
            "seg": Segmentation(stream=None, **self._seg_kwargs),
            "consumed": 0,  # seg._results frames already streamed
            "slot": None,
            "mfcc": None,
            "buffer": [],  # speech samples awaiting dB calibration
            "speech": [],  # all streamed speech samples (for ref replays)
            "ref": None,  # current causal dB reference (mel power)
            "tail": np.zeros(0, np.float32),  # sub-frame sample remainder
            # Streaming abandoned for this utterance (ring overflow) —
            # finals are unaffected; resets with the next utterance.
            "overflow": False,
        }

    def _check(self, session: int) -> dict:
        if session not in self._sessions:
            raise KeyError(f"session {session} is not open")
        return self._sessions[session]

    # -- serving loop ----------------------------------------------------------
    def feed(
        self, feeds: Dict[int, np.ndarray]
    ) -> Dict[int, List[UtteranceResult]]:
        """Feed raw sample chunks; returns utterances finished this call."""
        # pending: (session, signal, slot-or-None) per endpoint this call.
        pending: List[tuple] = []
        stream_feeds: Dict[int, np.ndarray] = {}
        for session, samples in feeds.items():
            self._feed_session(
                session, np.asarray(samples, np.float32).reshape(-1),
                stream_feeds, pending,
            )
        # ONE round set advances every talking session's online decode —
        # endpoint flushes included (slots released only below, so a
        # successor utterance in the same call cannot collide). Batching
        # these was measured essential: per-endpoint step+finalize paid a
        # full-pool upload and a ~90 ms readback sync EACH (the dominant
        # cost of the partials path at 1024 sessions).
        if self._pool is not None and stream_feeds:
            blocks = list(_chunk_rounds(stream_feeds, self._pool.chunk_size))
            for j, block in enumerate(blocks):
                # Once the caller has polled partials at least once, the
                # LAST round of each feed() also dispatches the any-state
                # finalize and starts its async readback — the next
                # partials() poll then costs no blocking device sync
                self._pool.step(
                    block,
                    partials=self._polls_partials and j == len(blocks) - 1,
                )
        last_partials: Dict[int, str] = {}
        endpointed = [slot for _s, _sig, slot in pending if slot is not None]
        if self._pool is not None and endpointed:
            results = self._pool.finalize(endpointed)
            for slot in endpointed:
                # The utterance is complete, so terminate like the offline
                # decoder (best word-exit) — any-state partial termination
                # would hallucinate a word onset from residual frames.
                last_partials[slot] = results[slot][1]
                self._pool.release(slot)
        finished = [
            (session, signal, last_partials.get(slot, ""))
            for session, signal, slot in pending
            if len(signal)
        ]

        out: Dict[int, List[UtteranceResult]] = {}
        if finished:
            signals = [sig for _s, sig, _p in finished]
            confs: List[Optional[float]] = [None] * len(finished)
            if self._confidences:
                # Host features, the dense decode and the posterior passes.
                feats = mfcc_batch(signals, cfg=self._mcfg, device=self._decoder.device)
                scored = self._decoder.predict_batch_with_confidence(feats)
                texts = ["".join(w for w, _s, _e, _c in words) for words in scored]
                confs = [min((c for _w, _s, _e, c in words), default=0.0)
                         for words in scored]
            else:
                # Offline-parity finals, decoded as one batch on the device:
                # MFCC + emissions + trellis + word compaction.
                texts = self._decoder.predict_signal_batch(signals, mcfg=self._mcfg)
            for (session, signal, last_partial), text, conf in zip(finished, texts, confs):
                out.setdefault(session, []).append(
                    UtteranceResult(
                        session=session, text=text,
                        num_samples=len(signal), last_partial=last_partial,
                        confidence=conf,
                    )
                )
        return out

    def partial(self, session: int) -> str:
        """Live streaming hypothesis for one session ("" outside speech or
        with partials disabled). Polling many sessions? Use partials()."""
        return self.partials([session])[session]

    def partials(self, sessions: Sequence[int] | None = None
                 ) -> Dict[int, str]:
        """Live hypotheses for many sessions in ONE pool finalize (polling
        per session would cost a full-pool finalize each)."""
        if sessions is None:
            sessions = sorted(self._sessions)
        states = {s: self._check(s) for s in sessions}
        if self._pool is None:
            return {s: "" for s in sessions}
        self._polls_partials = True
        slot_of = {
            s: st["slot"] for s, st in states.items()
            if st["slot"] is not None
        }
        texts = (
            self._pool.partial_texts(
                list(slot_of.values()),
                stale_ok=not self._partials_exact,
            )
            if slot_of else {}
        )
        return {
            s: texts.get(slot_of.get(s), "") for s in sessions
        }

    # -- internals --------------------------------------------------------------
    def _feed_session(self, session: int, samples: np.ndarray,
                      stream_feeds: dict, pending: list) -> None:
        """Frame-accurate endpointing: samples buffer to exact 320-sample
        frames (the sub-frame remainder carries across feed() calls AND
        across utterances). The hysteresis machine advances a whole chunk
        per native call (Segmentation.feed_frames — the C++ streaming
        endpointer); an endpoint consumes exactly the frames up to it, and
        the remainder re-feeds a fresh state so audio after an endpoint
        flows into the NEXT utterance instead of being lost. Endpoints
        append (session, signal, slot) to `pending`; feed() finalizes/
        releases the slots in one batch."""
        state = self._check(session)
        fs = state["seg"].frame_size
        buf = (
            np.concatenate([state["tail"], samples])
            if len(state["tail"]) else samples
        )
        n_full = len(buf) // fs
        state["tail"] = buf[n_full * fs:]
        off, end = 0, n_full * fs
        while off < end:
            seg = state["seg"]
            done, consumed = seg.feed_frames(buf[off:end])
            off += consumed
            if not done:
                # Stream once per feed() call, not per frame: the per-frame
                # variant made the host loop quadratic at scale (every call
                # re-ran the holdback/calibration bookkeeping and the causal
                # front-end's edge logic).
                self._advance_stream(state, stream_feeds)
            else:
                # Flush the utterance's tail frames into the step-wide batch
                # so the final streaming hypothesis covers the whole
                # utterance. The flush may extend frames already queued for
                # this slot; the slot itself is finalized+released by feed()
                # AFTER the batched rounds run, and a successor utterance
                # cannot collide with it because release is deferred.
                self._advance_stream(state, stream_feeds, flush=True)
                pending.append(
                    (session, seg.result_signal(), state["slot"])
                )
                tail = state["tail"]
                state = self._fresh_state()
                state["tail"] = tail
                self._sessions[session] = state
    def _advance_stream(self, state: dict, stream_feeds: dict,
                        flush: bool = False) -> None:
        """Route newly captured speech frames into the streaming decoder.

        The causal dB reference starts from the first ~0.2 s of speech; when
        later audio exceeds it by RECALIBRATION_RATIO (speech onsets are
        quieter than peaks, so the initial estimate is usually low), the
        reference upgrades and the utterance-so-far REPLAYS through a fresh
        front-end and a fresh slot — a ~1 s replay is one extra pool step.

        Streaming also HOLDS BACK the endpointer's trailing-trim window
        (maximum_silence_frames worth of samples): the offline path never
        decodes those trailing-silence frames (result_signal trims them),
        and under the utterance-global dB floor they clip into features the
        silence model has never seen — measured to decode as a spurious
        trailing word even with parity features. Held-back samples stream
        once newer audio proves they are not trailing; at the endpoint they
        are dropped exactly like result_signal drops them."""
        if self._pool is None:
            return
        seg = state["seg"]
        new = seg._results[state["consumed"]:]
        state["consumed"] = len(seg._results)
        if state["overflow"]:
            # Ring overflowed earlier in this utterance: streaming is off
            # until the endpoint (fresh state resets the flag). New frames
            # are consumed and dropped so buffers stay bounded.
            return
        if new:
            state["buffer"].append(
                np.concatenate([np.asarray(f).reshape(-1) for f in new])
            )
        holdback = seg._end_counter.frame_count_threshold * seg.frame_size
        pending = (
            np.concatenate(state["buffer"])
            if state["buffer"] else np.zeros(0, np.float32)
        )
        if flush:
            # Drop the trailing-trim window (kept whole when trimming would
            # leave nothing — mirroring result_signal's fallback).
            streamed = int(sum(len(s) for s in state["speech"]))
            if streamed + len(pending) > holdback:
                samples = pending[: max(len(pending) - holdback, 0)]
            else:
                samples = pending
            state["buffer"] = []
        else:
            samples = pending[: max(len(pending) - holdback, 0)]
            state["buffer"] = [pending[len(samples):]]
        frames = np.zeros((0, 39), np.float32)
        if state["mfcc"] is None:
            if len(samples) == 0 or (
                len(samples) < self._calibration_samples and not flush
            ):
                # Not calibrating yet: nothing was consumed — keep ALL
                # pending samples buffered (the slice above must not lose
                # the feedable prefix).
                state["buffer"] = [pending] if len(pending) else []
                return
            try:
                state["slot"] = self._pool.start()
            except RuntimeError:
                # Pool momentarily exhausted — e.g. a session endpointed AND
                # its successor utterance calibrated within one feed() call
                # while every slot was claimed (endpoint releases are
                # deferred past the batched rounds). Keep the speech
                # buffered; the stream starts on a later call once slots
                # free up. Finals are unaffected.
                logger.info("streaming pool full; partials for this "
                            "utterance start when a slot frees")
                state["buffer"] = [pending] if len(pending) else []
                return
            state["ref"] = mel_peak(samples, self._mcfg)
            state["mfcc"] = StreamingMFCC(
                cfg=self._mcfg, ref_power=state["ref"]
            )
            state["speech"] = [samples]
            frames = state["mfcc"].feed(samples)
        elif len(samples):
            # Recalibration check from the front-end's OWN frame pass (the
            # former separate mel_peak() over the raw chunk re-did the DFT
            # work per session per round). Feed first, read the chunk's
            # peak; on an exceedance the slot is released and the whole
            # utterance replays through a fresh front-end anyway, so the
            # just-fed frames are discarded exactly as before.
            state["speech"].append(samples)
            frames = state["mfcc"].feed(samples)
            peak = state["mfcc"].last_feed_mel_peak
            if peak > state["ref"] * self.RECALIBRATION_RATIO:
                state["ref"] = peak
                state["mfcc"] = StreamingMFCC(
                    cfg=self._mcfg, ref_power=peak
                )
                stream_feeds.pop(state["slot"], None)
                self._pool.release(state["slot"])
                state["slot"] = self._pool.start()
                frames = state["mfcc"].feed(
                    np.concatenate(state["speech"])
                )
        if flush and state["mfcc"] is not None:
            tail = state["mfcc"].finalize()
            if len(tail):
                frames = (
                    np.concatenate([frames, tail]) if len(frames) else tail
                )
        if len(frames):
            slot = state["slot"]
            # Ring-capacity guard: one utterance with
            # continuous speech past max_frames must not ValueError out of
            # pool.step() and abort the whole feed() call. On overflow the
            # slot is released and this utterance continues finals-only,
            # mirroring the pool-exhaustion path.
            queued = len(stream_feeds.get(slot, ()))
            if (
                self._pool.fill_of(slot) + queued + len(frames)
                > self._pool.max_frames
            ):
                logger.info(
                    "streaming ring full (slot %s, max_frames=%d): partials "
                    "stop for this utterance; finals unaffected",
                    slot, self._pool.max_frames,
                )
                stream_feeds.pop(slot, None)
                self._pool.release(slot)
                state["slot"] = None
                state["mfcc"] = None
                state["buffer"] = []
                state["speech"] = []
                state["overflow"] = True
                return
            stream_feeds[slot] = (
                np.concatenate([stream_feeds[slot], frames])
                if slot in stream_feeds else frames
            )



def _chunk_rounds(stream_feeds: Dict[int, np.ndarray], chunk: int):
    """Split per-slot frame runs into synchronized <=chunk_size rounds."""
    pieces = {
        slot: [frames[o : o + chunk] for o in range(0, len(frames), chunk)]
        for slot, frames in stream_feeds.items()
    }
    rounds = max((len(v) for v in pieces.values()), default=0)
    for j in range(rounds):
        yield {
            slot: blocks[j] for slot, blocks in pieces.items()
            if j < len(blocks)
        }


