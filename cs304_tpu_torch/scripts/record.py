"""Raw timed mic recording to recordings/<timestamp>.wav
(reference scripts/record.py). Requires sounddevice."""
import argparse
import os
import time

import numpy as np

from cs304_tpu_torch.audio.wav import write_wav_int16
from cs304_tpu_torch.scripts._common import run_main


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--sample-rate", type=int, default=16000)
    parser.add_argument("--out-dir", default="./recordings")
    args = parser.parse_args(argv)
    try:
        import sounddevice as sd
    except Exception as e:
        raise SystemExit(f"sounddevice unavailable: {e}")

    input("Press enter to record")
    data = sd.rec(
        int(args.seconds * args.sample_rate),
        samplerate=args.sample_rate, channels=1, dtype=np.int16,
    )
    sd.wait()
    path = os.path.join(args.out_dir, f"{int(time.time())}.wav")
    write_wav_int16(path, data.reshape(-1), args.sample_rate)
    print("saved:", path)


if __name__ == "__main__":
    run_main(main)
