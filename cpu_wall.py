"""Wall time of the posterior and n-best searches on the CPU, in one or more
checkouts run in turn.

    python3 cpu_wall.py [CHECKOUT ...] [--order ABBA] [--reps 5]

Each run is a process of its own in one checkout (default: this one), with
torch on one thread: the flagship decoder (flagship_models(), 58 states,
penalty -100) with device="cpu", on 64 clips of random 39-dim features,
150..256 frames from a fixed seed (phase 22's batch shape: 128-padded to
T = 256). It times predict_batch_with_confidence on the 64 clips and
predict_nbest(n=4) on the first clip, best of --reps after one warm-up
call, and within each the time spent in its search (ops/lattice._sum_passes,
ops/nbest.kbest_composite_forward, which both checkouts' entry points call
through their module); it checks that both return a result. --order names
the checkouts' run order by letter (A the first checkout): ABBA puts two
checkouts in the same stretch of the host's time. Prints a line a run and
a JSON object of every run last.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def child(reps: int) -> dict:
    sys.path.insert(0, os.getcwd())  # the checkout, ahead of this script's directory
    import numpy as np
    import torch

    import cs304_tpu_torch
    from cs304_tpu_torch.models import decoder as dm
    from cs304_tpu_torch.models.hmm import flagship_models
    from cs304_tpu_torch.ops import lattice as tla
    from cs304_tpu_torch.ops import nbest as tnb

    spent = {}

    def timed(module, name):
        inner = getattr(module, name)

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        setattr(module, name, run)

    timed(tla, "_sum_passes")
    timed(tnb, "kbest_composite_forward")
    torch.set_num_threads(1)
    rng = np.random.default_rng(22)
    clips = [rng.normal(size=(int(n), 39)).astype(np.float32)
             for n in rng.integers(150, 257, 64)]
    dec = dm.ContinuousDecoder(flagship_models(), penalty=-100.0, device="cpu")
    out = {"package": cs304_tpu_torch.__file__}
    for what, fn, search in (
            ("confidences_64_clips", lambda: dec.predict_batch_with_confidence(clips),
             "_sum_passes"),
            ("nbest_1_clip_n4", lambda: dec.predict_nbest(clips[0], n=4),
             "kbest_composite_forward")):
        got = fn()
        if not got:
            raise SystemExit(f"{what}: empty result")
        walls = []
        for _ in range(reps):
            spent.clear()
            t0 = time.perf_counter()
            fn()
            walls.append(((time.perf_counter() - t0) * 1e3, spent.get(search, 0.0)))
        out[what + "_ms"], out[what + "_search_ms"] = min(walls)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*", type=Path)
    ap.add_argument("--order", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.reps)))
        return
    checkouts = [c.resolve() for c in args.checkouts] or [Path(__file__).resolve().parent]
    order = args.order or "".join(chr(65 + i) for i in range(len(checkouts)))
    runs = []
    for letter in order:
        where = checkouts[ord(letter) - 65]
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                               "--reps", str(args.reps)], cwd=where,
                              capture_output=True, text=True, check=False)
        if done.returncode != 0:
            raise SystemExit(f"run {letter} in {where} failed:\n{done.stderr[-4000:]}")
        row = {"run": letter, "checkout": str(where),
               **json.loads(done.stdout.strip().splitlines()[-1])}
        print(row, flush=True)
        runs.append(row)
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main()
