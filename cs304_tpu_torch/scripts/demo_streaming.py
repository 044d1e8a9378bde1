"""Streaming decode demo: feed a WAV in small chunks through the causal MFCC
front-end and the online trellis, printing the partial hypothesis as it grows.
The final hypothesis matches the offline decoder (printed for comparison).

(no reference equivalent — the reference decodes only after the endpointer
closes the utterance, scripts/project6_interactive.py:29-39 there)
"""
from dataclasses import replace

from cs304_tpu_torch.scripts._common import (
    run_main, adopt_checkpoint_frontend, base_parser, load_config,
)

from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.ops.streaming import StreamingComposite
from cs304_tpu_torch.ops.streaming_mfcc import StreamingMFCC, mel_peak
from cs304_tpu_torch.utils.checkpoint import load_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--wav", required=True)
    parser.add_argument("--chunk-ms", type=float, default=100.0)
    args = parser.parse_args(argv)
    cfg = load_config(args)
    models = load_models(cfg.checkpoint_dir)
    decoder = ContinuousDecoder(models, penalty=cfg.decode.word_penalty,
                                device=args.device)

    from cs304_tpu_torch.audio.wav import read_wav

    rate, signal = read_wav(args.wav)
    # CMVN checkpoints cannot stream (utterance-global statistics) —
    # StreamingMFCC raises a clear error in that case.
    adopt_checkpoint_frontend(cfg, args)
    mcfg = replace(cfg.frontend.mfcc_config(), sample_rate=float(rate))
    sm = StreamingMFCC(cfg=mcfg, ref_power=mel_peak(signal, mcfg))
    # GMM-aware: K-mixture checkpoints stream with their true densities.
    stream = StreamingComposite.from_models(
        models, penalty=cfg.decode.word_penalty, chunk_size=32,
        device=args.device,
    )

    chunk = int(args.chunk_ms / 1000 * rate)
    for start in range(0, len(signal), chunk):
        frames = sm.feed(signal[start : start + chunk])
        if len(frames):
            stream.feed(frames)
        print(f"t={min(start + chunk, len(signal)) / rate:6.2f}s  "
              f"partial: {stream.partial_labels()!r}")
    tail = sm.finalize()
    if len(tail):
        stream.feed(tail)
    score, path = stream.finalize()
    final = "".join(decoder.composite.path_to_labels(path))
    print(f"\nstreaming final:  {final!r}  (score {score:.1f})")

    offline = decoder.predict(mfcc_batch([signal], cfg=mcfg, device=args.device)[0])
    print(f"offline decode:   {offline!r}")


if __name__ == "__main__":
    run_main(main)
