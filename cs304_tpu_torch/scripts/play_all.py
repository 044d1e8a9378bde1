"""Play back all captured segments with sine-beep separators
(reference scripts/play_all.py). Requires sounddevice."""
import argparse
import os

import numpy as np

from cs304_tpu_torch.audio.wav import read_wav
from cs304_tpu_torch.scripts._common import run_main


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dir", default="./segment_results")
    parser.add_argument("--sample-rate", type=int, default=16000)
    args = parser.parse_args(argv)
    try:
        import sounddevice as sd
    except Exception as e:
        raise SystemExit(f"sounddevice unavailable: {e}")

    beep = (np.sin(2 * np.pi * 880 * np.arange(0.2 * args.sample_rate)
                   / args.sample_rate) * 8000).astype(np.int16)
    for name in sorted(os.listdir(args.dir)):
        if not name.lower().endswith(".wav"):
            continue
        rate, signal = read_wav(os.path.join(args.dir, name))
        print("playing:", name)
        sd.play(signal.astype(np.int16), rate)
        sd.wait()
        sd.play(beep, args.sample_rate)
        sd.wait()


if __name__ == "__main__":
    run_main(main)
