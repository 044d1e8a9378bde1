"""Mic -> endpoint -> MFCC -> isolated argmax prediction
(reference scripts/project4_phone_interactive.py / project5_interactive_single.py).
Requires sounddevice; --wav classifies a file instead.

Also provides the CONTINUOUS interactive mode that the reference's
project5_interactive_multi.py intended but never implemented (it calls the
nonexistent ModelCollection.predict_continuous_controller — SURVEY.md §2 #14):
pass --continuous to decode digit strings.
"""
from dataclasses import replace

from cs304_tpu_torch.scripts._common import (
    run_main, adopt_checkpoint_frontend, base_parser, load_config,
)

from cs304_tpu_torch.data.ti_digits import DIGIT_LABELS
from cs304_tpu_torch.models.collection import ModelCollection
from cs304_tpu_torch.models.decoder import ContinuousDecoder
from cs304_tpu_torch.ops.mfcc import mfcc_batch
from cs304_tpu_torch.utils.checkpoint import load_models


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--wav", default=None)
    parser.add_argument("--continuous", action="store_true")
    args = parser.parse_args(argv)
    cfg = load_config(args)
    models = load_models(cfg.checkpoint_dir)
    adopt_checkpoint_frontend(cfg, args)
    mcfg = cfg.frontend.mfcc_config()
    if args.continuous:
        predictor = ContinuousDecoder(models, penalty=cfg.decode.word_penalty,
                                      device=args.device).predict
    else:
        mc = ModelCollection.from_models(
            [models[l] for l in DIGIT_LABELS if l in models], device=args.device
        )
        predictor = mc.predict

    def classify(signal, rate):
        feats = mfcc_batch([signal], cfg=replace(mcfg, sample_rate=float(rate)),
                           device=args.device)
        print("predicted:", predictor(feats[0]))

    if args.wav:
        from cs304_tpu_torch.audio.wav import read_wav

        rate, signal = read_wav(args.wav)
        classify(signal, rate)
        return

    from cs304_tpu_torch.audio.capture import Segmentation
    from cs304_tpu_torch.audio.wav import read_wav

    seg = Segmentation.from_basic(sample_rate=int(cfg.frontend.sample_rate))
    while True:
        path = seg.main()
        if path:
            rate, signal = read_wav(path)
            classify(signal, rate)


if __name__ == "__main__":
    run_main(main)
