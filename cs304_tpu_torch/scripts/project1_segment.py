"""Live mic endpointing demo: press-to-talk, result saved to
segment_results/result.wav (reference scripts/project1.py). Requires sounddevice."""
from cs304_tpu_torch.scripts._common import run_main, base_parser, load_config

from cs304_tpu_torch.audio.capture import Segmentation


def main(argv=None) -> None:
    parser = base_parser(__doc__)
    parser.add_argument("--high", type=float, default=512.0)
    parser.add_argument("--low", type=float, default=64.0)
    parser.add_argument("--silence-duration", type=float, default=0.1)
    args = parser.parse_args(argv)
    cfg = load_config(args)
    seg = Segmentation.from_basic(
        sample_rate=int(cfg.frontend.sample_rate),
        speech_high_threshold=args.high,
        speech_low_threshold=args.low,
        silence_duration_threshold=args.silence_duration,
    )
    path = seg.main()
    print("saved:", path)


if __name__ == "__main__":
    run_main(main)
