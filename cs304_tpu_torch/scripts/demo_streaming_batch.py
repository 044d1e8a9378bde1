"""Batched streaming demo: several concurrent "microphones" decoded online
in ONE device dispatch per chunk interval (ops/streaming_batch.py).

Each stream gets its own causal MFCC front-end; streams start staggered,
advance chunk-synchronously, and finalize independently (slots recycle).
Finals are compared against the offline decoder.

(no reference equivalent — the reference decodes one finished utterance at a
time, scripts/project6_interactive.py:29-39 there)
"""
from dataclasses import replace

from cs304_tpu_torch.scripts._common import (
    adopt_checkpoint_frontend, base_parser, load_config, run_main,
)

import numpy as np

from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.ops.streaming_batch import BatchedStreamingComposite
from cs304_tpu_torch.ops.streaming_mfcc import StreamingMFCC, mel_peak
from cs304_tpu_torch.utils.checkpoint import load_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--wav", action="append", default=[],
                        help="WAV to stream (repeatable); default: three "
                             "synthetic sentences")
    parser.add_argument("--chunk-ms", type=float, default=160.0)
    parser.add_argument("--stagger-steps", type=int, default=2,
                        help="steps between consecutive stream starts")
    args = parser.parse_args(argv)
    cfg = load_config(args)
    models = load_models(cfg.checkpoint_dir)
    adopt_checkpoint_frontend(cfg, args)

    signals, names = [], []
    if args.wav:
        from cs304_tpu_torch.audio.wav import read_wav

        for path in args.wav:
            rate, signal = read_wav(path)
            signals.append((float(rate), signal))
            names.append(path)
    else:
        from cs304_tpu_torch.data.synthetic import SyntheticTIDigits

        corpus = SyntheticTIDigits(num_train_speakers=6, num_test_speakers=2,
                                   takes_per_digit=3)
        for i, tr in enumerate(("375", "186Z", "54321")):
            signals.append((16000.0, corpus.sentence_audio(tr, i % 6)))
            names.append(f"synthetic:{tr}")

    pool = BatchedStreamingComposite.from_models(
        models, penalty=cfg.decode.word_penalty,
        num_slots=max(4, len(signals)), chunk_size=32, device=args.device,
    )
    decoder = ContinuousDecoder(models, penalty=cfg.decode.word_penalty,
                                device=args.device)

    # Per-stream causal front-end + sample cursor; staggered starts.
    streams = {}
    for i, (rate, signal) in enumerate(signals):
        mcfg = replace(cfg.frontend.mfcc_config(), sample_rate=rate)
        streams[i] = {
            "sm": StreamingMFCC(cfg=mcfg, ref_power=mel_peak(signal, mcfg)),
            "signal": signal,
            "rate": rate,
            "cursor": 0,
            "slot": None,
            "start_step": i * args.stagger_steps,
        }

    step = 0
    while any(s["cursor"] < len(s["signal"]) or s["slot"] is None
              for s in streams.values()):
        pieces = {}  # slot -> [<=chunk_size frame blocks] from this interval
        for i, s in streams.items():
            if step < s["start_step"] or s["cursor"] >= len(s["signal"]):
                continue
            if s["slot"] is None:
                s["slot"] = pool.start()
                print(f"step {step}: stream {i} ({names[i]}) -> slot {s['slot']}")
            chunk = int(args.chunk_ms / 1000 * s["rate"])
            frames = s["sm"].feed(
                s["signal"][s["cursor"] : s["cursor"] + chunk]
            )
            s["cursor"] += chunk
            if s["cursor"] >= len(s["signal"]):
                tail = s["sm"].finalize()
                if len(tail):
                    frames = np.concatenate([frames, tail]) if len(frames) else tail
            if len(frames):
                pieces[s["slot"]] = [
                    frames[o : o + pool.chunk_size]
                    for o in range(0, len(frames), pool.chunk_size)
                ]
        # ONE dispatch advances every active stream (a 160 ms interval fits
        # one 32-frame chunk; the causal front-end occasionally emits more,
        # which spills into a second synchronized round).
        for j in range(max((len(v) for v in pieces.values()), default=0)):
            pool.step({slot: blocks[j] for slot, blocks in pieces.items()
                       if j < len(blocks)})
        fills = pool.fill()
        partials = {
            i: pool.partial_text(s["slot"])
            for i, s in streams.items()
            if s["slot"] is not None and fills.get(s["slot"], 0) > 0
        }
        print(f"step {step}: fill={fills} partials={partials}")
        step += 1

    print()
    for i, s in streams.items():
        score, text = pool.finalize([s["slot"]])[s["slot"]]
        feats = mfcc_batch(
            [s["signal"]],
            cfg=replace(cfg.frontend.mfcc_config(), sample_rate=s["rate"]),
            device=args.device,
        )
        offline = decoder.predict(feats[0])
        print(f"{names[i]}: streamed {text!r} (score {score:.1f}); "
              f"offline {offline!r}")
        pool.release(s["slot"])


if __name__ == "__main__":
    run_main(main)
