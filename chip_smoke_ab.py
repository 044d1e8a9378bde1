"""Wall time of chip_smoke.py in two checkouts, run in turn on one card.

    python3 chip_smoke_ab.py PARENT_DIR CHANGE_DIR --out DIR [--order ABBA]

Runs ``python3 chip_smoke.py`` in each checkout in the given order (A is
the first directory, B the second; the default ABBA puts both in the same
stretch of the card's and the host's time), each from an empty
``cs304_tpu_torch/_build/`` so that every run compiles its kernels as a fresh
checkout does. Each output line is stamped with the seconds since its run
began; the full stamped logs go to DIR.
Prints, per run, its exit code and wall seconds, and the second at which
each log tag (``[build]``, ``[K1]``, ``[legacy-train]``, ...) first
appears, so the time between two tags is what the phases between them
took. Exits non-zero if any run failed.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path


def run_once(checkout: Path, log_path: Path):
    shutil.rmtree(checkout / "cs304_tpu_torch" / "_build", ignore_errors=True)
    first = {}
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=checkout,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            now = time.perf_counter() - t0
            log.write(f"{now:9.2f} {line}")
            if line.startswith("[") and "]" in line:
                first.setdefault(line[: line.index("]") + 1], round(now, 2))
        code = proc.wait()
    return code, round(time.perf_counter() - t0, 2), first


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    dirs = {"A": args.a.resolve(), "B": args.b.resolve()}
    failed = False
    for i, label in enumerate(args.order):
        code, wall, first = run_once(dirs[label], args.out / f"run{i}_{label}.log")
        failed |= code != 0
        print(json.dumps({"run": i, "checkout": label, "dir": str(dirs[label]),
                          "exit": code, "wall_s": wall, "first_seen_s": first}), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
