"""Validate a TI-Digits directory tree before training: split/label coverage,
sample rates, durations, clip health. Run this first when pointing the
framework at real data (the layout is <root>/{Adults,Children}/TIDIGITS/
{TRAIN,TEST}, reference ti_digits.py:163-188)."""
from cs304_tpu_torch.scripts._common import (
    run_main, base_parser, load_config, load_corpus,
)

import numpy as np

from cs304_tpu_torch.data.ti_digits import DIGIT_LABELS


def describe(name, loader, sample_rate):
    labels = loader.labels
    n_digit_labels = [l for l in labels if l in DIGIT_LABELS]
    multi = [l for l in labels if len(l) > 1]
    print(f"\n{name}: {loader.num_clips()} clips, {len(labels)} labels "
          f"({len(n_digit_labels)} single-digit, {len(multi)} multi-digit)")
    missing = sorted(set(DIGIT_LABELS) - set(labels))
    if missing:
        print(f"  WARNING: missing single-digit labels: {missing}")
    durations = []
    bad = 0
    for label in labels[:50]:
        for clip in loader[label][:3]:
            if not len(clip) or not np.isfinite(clip).all():
                bad += 1
                continue
            durations.append(len(clip) / sample_rate)
    if durations:
        print(f"  sampled durations: min {min(durations):.2f}s, "
              f"median {np.median(durations):.2f}s, max {max(durations):.2f}s")
    if bad:
        print(f"  WARNING: {bad} sampled clips empty or non-finite")
    lengths = {len(l) for l in labels}
    print(f"  transcript lengths present: {sorted(lengths)}")


def main(argv=None) -> None:
    args = base_parser(__doc__).parse_args(argv)
    cfg = load_config(args)
    corpus = load_corpus(args, cfg)
    sr = cfg.frontend.sample_rate
    describe("train split", corpus.train_dataset, sr)
    describe("test split", corpus.test_dataset, sr)
    print("\ncorpus looks usable" if corpus.train_dataset.num_clips()
          else "\nERROR: empty train split")


if __name__ == "__main__":
    run_main(main)
