"""Measure the mic's noise floor and speech level for threshold calibration
(reference scripts/mic_testing.py). Requires sounddevice."""
import argparse

import numpy as np

from cs304_tpu_torch.scripts._common import run_main


def measure(sd, seconds: float, sample_rate: int, prompt: str) -> float:
    input(prompt)
    data = sd.rec(int(seconds * sample_rate), samplerate=sample_rate,
                  channels=1, dtype=np.int16)
    sd.wait()
    return float(np.mean(np.abs(data.astype(np.float32))))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--sample-rate", type=int, default=16000)
    args = parser.parse_args(argv)
    try:
        import sounddevice as sd
    except Exception as e:
        raise SystemExit(f"sounddevice unavailable: {e}")

    noise = measure(sd, args.seconds, args.sample_rate,
                    "Press enter and stay SILENT...")
    speech = measure(sd, args.seconds, args.sample_rate,
                     "Press enter and SPEAK normally...")
    print(f"noise floor:  {noise:.1f}")
    print(f"speech level: {speech:.1f}")
    print(f"suggested high threshold: {0.5 * speech:.0f}")
    print(f"suggested low threshold:  {max(2 * noise, 0.05 * speech):.0f}")


if __name__ == "__main__":
    run_main(main)
