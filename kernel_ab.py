"""One hand-written kernel built from one or more sources and timed in turns.

    python3 kernel_ab.py KERNEL --lib N=SOURCE.cu --lib P=OTHER.cu \
        --order P,N,N,P [--shapes a,b,...] [--simple] [--out FILE]

KERNEL is ``lattice_max`` (LMAX, ``csrc/trellis_lattice.cu``), ``fb_dense``
(FBD, ``csrc/forward_backward.cu``) or ``fb_posteriors`` (FB's E-step mode,
``csrc/trellis_fb.cu``). Each source is a version of the
kernel's file (a parent commit's from ``git show
<commit>:cs304_tpu_torch/csrc/trellis_lattice.cu``, or an edited copy) that
nvcc compiles into a library of its own, all at once, printing ptxas'
registers and spills of the kernel's builds. At each shape every library's
outputs are compared with the kernel's plain version on the same CUDA
tensors (the cells whose bits differ, signs of zero included, NaN cells
equal; each library runs once on outputs filled with each of chip_smoke.py's
two kernel poisons, the plain version under its third), then each library
is timed in the order given (device time of CUDA-graph replays, best of 5),
printed as µs a step.

- ``lattice_max``: phase 31's shapes and a composite for each build of the
  team branch (as ``tests/test_torch_cuda_kernels.py`` LMAX_BUILDS);
  ``--simple`` adds the first library's first design (``simple=1``) in
  turns beside its plan's branch (s n n s); each row gives the first
  library's plan.
- ``fb_dense``: the posteriors mode at the main path's word call (B=18,
  T=128, S=5, lengths 20..37 as phase 9's clips, a left-to-right log_a with
  -inf entries), chip_smoke.py phase 32's seeded word shape (B=256, T=128,
  S=5, no final) and a legacy-trainer-like one (B=128, T=256, S=59, the
  banded matrix of a left-to-right model, a pinned final); a step is one of
  the call's chain steps (2 (longest row - 1)). An order entry ``N@BUILD``
  runs library N on one of its builds (``cs304_fb_dense_on``, FBD_BUILDS'
  names); each library that has that entry also times its skeleton (the
  forward's chain cut to its exchange) as µs a forward step. ``--mode``
  times the forward or backward mode instead.
- ``fb_posteriors``: the E-step at chip_smoke.py phase 19's shapes (the
  trainer's B=896, T=160, S=59; 98, 503 and 2100 states; T=4000), drawn
  by its ``fb_problem``; a step is one of the forward's or the backward's
  (2 (longest row - 1)); ``--mode fb`` times FB's alpha/beta mode.

Exits non-zero where a library disagrees with the plain version. Needs a
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from chip_smoke import KERNEL_POISONS, plain_run, poison_  # noqa: E402
from cs304_tpu_torch.models.hmm import (  # noqa: E402
    WordHMM,
    flagship_composite,
    stack_word_models,
    uniform_forward_log_a,
)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(name, path, workdir, kernel):
    """nvcc one source into its own library -> (name, lib, ptxas lines of
    the entry functions whose name holds the kernel's tag)."""
    out = os.path.join(workdir, f"{name}.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-o", out, path]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    res, cur = [], None
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            cur = m[1] if kernel.tag in m[1] else None
        elif cur and ("registers" in line or "spill" in line):
            info = re.sub(r".*:\s*", "", line.strip())
            res.append(re.sub(rf".*{kernel.tag}_?", "", cur) + " " + info)
    lib = ctypes.CDLL(out)
    for symbol, argtypes in kernel.entries.items():
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = I
    for symbol, argtypes in getattr(kernel, "optional", {}).items():
        if hasattr(lib, symbol):
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = I
    return name, lib, res


def differing_cells(got, want):
    """Cells whose bits differ (NaN cells equal wherever both are NaN)."""
    if not want.dtype.is_floating_point:
        return int((got != want).sum())
    nan = torch.isnan(want)
    return int((torch.isnan(got) != nan).sum()) + int(
        (got.view(torch.int32) != want.view(torch.int32))[~nan & ~torch.isnan(got)].sum())


def device_ms(call, reps=20):
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            call()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    return best


class LatticeMax:
    tag = "lattice_max"
    entries = {"cs304_lattice_max": [P, P, P, P, P, F, I, P, P, P, P, I, I, I, I, I, P],
               "cs304_lattice_max_plan": [I, I, I, P]}
    # name: (word state counts (None: the flagship), penalty, T, length)
    shapes = {
        "58": (None, None, 201, 180), "58t59": (None, None, 59, 59),
        "single": ([1, 3, 1, 5, 1, 3], 0.0, 64, 40),
        "pool33": ([2, 1] * 16 + [3], -25.0, 40, 40),
        "375": ([5] * 75, -100.0, 201, 201), "503": ([5] * 100 + [3], -100.0, 201, 201),
        "1503": ([5] * 300 + [3], -100.0, 201, 201), "3003": ([5] * 600 + [3], -100.0, 100, 100),
        "5003": ([5] * 1000 + [3], -100.0, 60, 60), "8188": ([5] * 1637 + [3], -100.0, 30, 30),
        "long": ([250] * 20, -100.0, 150, 150),
        # The team branch's other builds (states a band thread, pool, cells a
        # lane, CTAs), and single-state words where the plan keeps the first
        # design.
        "k1-cells2": ([2] * 300, -100.0, 64, 64), "700-single": ([1] * 700, -100.0, 64, 64),
        "k2-dense": ([50] * 30, -100.0, 100, 100), "k2-cells1": ([10] * 150, -100.0, 64, 64),
        "k2-cells4": ([2] * 700, -100.0, 64, 64), "1100-single": ([1] * 1100, -100.0, 64, 64),
        "k4-dense": ([100] * 30, -100.0, 100, 100), "k4-cells1": ([20] * 150, -100.0, 64, 64),
        "k4-cells2": ([7] * 400, -100.0, 64, 64), "k4-cells8": ([2] * 1100, -100.0, 64, 64),
        "c2-cells2": ([12] * 400, -100.0, 64, 64), "c2-cells8": ([4] * 1100, -100.0, 64, 64),
        "c4-long": ([400] * 20, -100.0, 216, 216), "c4-cells2": ([20] * 400, -100.0, 64, 64),
        "c4-cells4": ([8] * 1000, -100.0, 64, 64),
    }

    def __init__(self, dev):
        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(5)

    @staticmethod
    def composite(counts, penalty):
        if counts is None:
            return flagship_composite()
        rng = np.random.default_rng(31)
        return stack_word_models(
            [WordHMM(f"w{i}", rng.normal(size=(n, 4)).astype(np.float32),
                     np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)), uniform_forward_log_a(n))
             for i, n in enumerate(counts)], penalty=penalty)

    def problem(self, key, first_lib):
        """-> (run(lib, simple), plain outputs, outputs, steps, row info)."""
        from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk

        counts, pen, t, length = self.shapes[key]
        comp = self.composite(counts, pen)
        dev = self.dev
        topo = tlk.lattice_topology(comp.log_a, comp.lower_of_state, comp.is_entry,
                                    comp.is_exit, comp.word_of_state, device=dev)
        # Sources from before the pool's carry bit was dropped read bit 8 of
        # ints row 3 at the entries (every pool pick new); later ones ignore it.
        topo.ints[3] |= 8 * (topo.coefs[4] > 0).to(torch.int32)
        s = comp.num_states
        lb = 3 * torch.randn((t, s), generator=self.gen, device=dev)
        want = plain_run(tlk.lattice_max_passes_plain, lb, topo, comp.penalty, length)
        outs = (torch.empty((t, s), device=dev),
                torch.empty((t, s), dtype=torch.int32, device=dev),
                torch.empty((t,), device=dev), torch.empty((), device=dev))

        def run(lib, simple):
            code = lib.cs304_lattice_max(
                lb.data_ptr(), topo.coefs.data_ptr(), topo.ints.data_ptr(),
                topo.exits.data_ptr(), topo.entries.data_ptr(), float(comp.penalty),
                int(length), *(o.data_ptr() for o in outs), t, s, topo.exits.numel(),
                topo.entries.numel(), int(simple), torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"cs304_lattice_max returned {code}")

        plan = (ctypes.c_int * 7)()
        first_lib.cs304_lattice_max_plan(s, topo.exits.numel(), topo.entries.numel(), plan)
        # (branch 0 team / 1 simple, states a band thread, dense, pool warps,
        # threads, cells a pool lane, CTAs) of the first library
        info = {"S": s, "T": t, "finite_score": bool(torch.isfinite(want[3])),
                "plan": list(plan)}
        return run, want, outs, t - 1, info


class FbDense:
    tag = "fb_dense"
    entries = {"cs304_fb_dense": [I, P, P, P, P, P, P, P, P, P, P, I, I, I, P]}
    optional = {"cs304_fb_dense_on": [I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, P]}
    # name: (B, T, S, matrix, pinned final, lengths), as chip_smoke.FBD_CASES
    shapes = {"wordcall": (18, 128, 5, "left-to-right", False, (20, 37)),
              "word": (256, 128, 5, "uniform", False, None),
              "legacy": (128, 256, 59, "banded", True, None)}

    def __init__(self, dev, mode=None):
        self.dev = dev
        self.mode = mode

    def problem(self, key, first_lib):
        from chip_smoke import fbd_chain, fbd_problem
        from cs304_tpu_torch.ops.cuda import forward_backward as fbd

        b, t, s, kind, pinned, span = self.shapes[key]
        log_b, log_a, log_init, lengths, final = fbd_problem(
            self.dev, b, t, s, kind, pinned, seed=b + t + s, lengths=span)
        mode_name = self.mode or "posteriors"
        want = plain_run(fbd.fb_dense_plain, log_b, log_a, log_init, lengths, final,
                         mode=mode_name)
        alpha, beta, gamma = (torch.empty_like(log_b) for _ in range(3))
        xi = torch.empty((b, s, s), device=self.dev)
        ll = torch.empty((b,), device=self.dev)
        outs = {"forward": (alpha, ll), "backward": (beta,), "posteriors": (gamma, xi, ll)}
        builds = list(fbd.FBD_BUILDS)

        def run(lib, build, mode=fbd.MODES.index(mode_name)):
            args = (log_b.data_ptr(), log_a.data_ptr(), log_init.data_ptr(),
                    final.data_ptr() if final is not None else None, lengths.data_ptr(),
                    alpha.data_ptr(), beta.data_ptr(), gamma.data_ptr(), xi.data_ptr(),
                    ll.data_ptr(), b, t, s, torch.cuda.current_stream().cuda_stream)
            if build:
                code = lib.cs304_fb_dense_on(builds.index(build), mode, *args)
            else:
                code = lib.cs304_fb_dense(mode, *args)
            if code:
                raise SystemExit(f"cs304_fb_dense returned {code}")

        def skeleton_us(lib, build):
            """The skeleton's µs a forward step, or None without the entry."""
            if not hasattr(lib, "cs304_fb_dense_on"):
                return None
            ms = device_ms(lambda: run(lib, build or fbd.fb_dense_plan(s), mode=3))
            return round(ms / fbd_chain(lengths, t, "forward") * 1e3, 4)

        info = {"B": b, "T": t, "S": s, "mode": mode_name, "plan": fbd.fb_dense_plan(s),
                "longest_row": int(lengths.clamp(max=t).max()), "skeleton": skeleton_us}
        want = want if isinstance(want, tuple) else (want,)
        return run, want, outs[mode_name], fbd_chain(lengths, t, mode_name), info


class FbPosteriors:
    """The E-step mode of the sentence forward-backward (FB,
    ``csrc/trellis_fb.cu``, ``banded_fb_posteriors``): gamma, xi sums, ll;
    with ``--mode fb`` its alpha/beta mode (``banded_fb``)."""
    tag = "trellis_fb"
    entries = {"cs304_trellis_fb_posteriors": [P, P, P, P, P, P, P, P, P, I, I, I, P],
               "cs304_trellis_fb": [P, P, P, P, P, P, P, P, P, I, I, I, P]}
    # name: (B, T, S), drawn as chip_smoke.py phase 19's cases (fb_problem:
    # -inf sprinkled, finals the band reaches); "train" is the trainer's
    # shape on random emissions.
    shapes = {"train": (896, 160, 59), "98": (32, 160, 98), "503": (16, 340, 503),
              "2100": (4, 1500, 2100), "t4000": (6, 4000, 59)}

    def __init__(self, dev, mode=None):
        self.dev = dev
        self.fb = mode == "fb"

    def problem(self, key, first_lib):
        from chip_smoke import fb_problem
        from cs304_tpu_torch.ops.cuda import trellis_fb as tfb

        b, t, s = self.shapes[key]
        args = fb_problem(self.dev, b, t, s, seed=b * 7 + s)
        plain = tfb.banded_fb_plain if self.fb else tfb.banded_fb_posteriors_plain
        want = plain_run(plain, *args)
        outs = tuple(torch.empty(w.shape, device=self.dev) for w in want)
        entry = "cs304_trellis_fb" if self.fb else "cs304_trellis_fb_posteriors"

        def run(lib, _flag):
            code = getattr(lib, entry)(
                *(x.data_ptr() for x in args), *(o.data_ptr() for o in outs), b, t, s,
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"{entry} returned {code}")

        # A step: one of the forward's and the backward's steps over the
        # longest row.
        steps = 2 * max(int(args[4].clamp(max=t).max()) - 1, 1)
        info = {"B": b, "T": t, "S": s, "mode": "fb" if self.fb else "posteriors",
                "finite_ll": int(torch.isfinite(want[2]).sum())}
        return run, want, outs, steps, info


KERNELS = {"lattice_max": LatticeMax, "fb_dense": FbDense, "fb_posteriors": FbPosteriors}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--lib", action="append", required=True, help="NAME=SOURCE.cu")
    ap.add_argument("--order", default=None, help="library names in timing order")
    ap.add_argument("--shapes", default=None, help="comma-separated; default all")
    ap.add_argument("--simple", action="store_true", help="lattice_max: time simple=1 too")
    ap.add_argument("--mode", default=None, choices=("forward", "backward", "posteriors", "fb"),
                    help="fb_dense: the mode timed (default posteriors); fb_posteriors: "
                         "fb times FB's alpha/beta mode")
    ap.add_argument("--out", default=None, help="also write the rows here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a card")
    dev = torch.device("cuda", 0)
    kernel = KERNELS[args.kernel](dev, **({"mode": args.mode} if args.mode else {}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip()
    print("card:", card, flush=True)
    specs = dict(x.split("=", 1) for x in args.lib)
    workdir = tempfile.mkdtemp(prefix="kernel_ab_")
    with ThreadPoolExecutor(len(specs)) as ex:
        built = list(ex.map(lambda kv: build(*kv, workdir, kernel), specs.items()))
    libs = {}
    for name, lib, res in built:
        print(name, "ptxas:", *res, sep="\n  ", flush=True)
        libs[name] = lib
    # An order entry is a library's name, or NAME@VARIANT (fb_dense: a build).
    order = (args.order or ",".join(libs)).split(",")
    first = order[0].split("@")[0]
    simple = args.simple and args.kernel == "lattice_max"
    rows = []
    for key in (args.shapes or ",".join(kernel.shapes)).split(","):
        run, want, outs, steps, info = kernel.problem(key, libs[first])
        skeleton = info.pop("skeleton", None)
        turns = [tuple(x.split("@")) if "@" in x else (x, 0) for x in order]
        if simple:
            turns = [(first, 1)] + turns + [(first, 1)]

        def label(name, flag):
            return name + (f"@{flag}" if isinstance(flag, str) else "-simple" if flag else "")

        differing = {}
        for name, flag in dict.fromkeys([(n, 0) for n in libs] + turns):
            # Once on outputs filled with each of chip_smoke.py's two kernel
            # poisons: a cell the run leaves unwritten differs under one.
            differing[label(name, flag)] = 0
            for pattern in KERNEL_POISONS:
                for o in outs:
                    poison_(o, pattern)
                run(libs[name], flag)
                torch.cuda.synchronize()
                differing[label(name, flag)] += sum(
                    differing_cells(g, w) for g, w in zip(outs, want))
        us = {}
        for name, flag in turns:
            ms = device_ms(lambda: run(libs[name], flag))
            us.setdefault(label(name, flag), []).append(round(ms / steps * 1e3, 4))
        row = {"shape": key, **info, "steps": steps, "differing_cells": differing,
               "us_step": us, "card": card}
        if skeleton:
            floors = {label(n, f): skeleton(libs[n], f or None) for n, f in dict.fromkeys(turns)}
            row["skeleton_us_forward_step"] = {k: v for k, v in floors.items() if v is not None}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if any(any(r["differing_cells"].values()) or not r.get("finite_score", True)
           for r in rows):
        raise SystemExit("kernel_ab: a library disagrees with the plain version")


if __name__ == "__main__":
    main()
