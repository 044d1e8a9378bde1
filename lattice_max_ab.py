"""LMAX (cs304_lattice_max) built from one or more sources and timed in turns.

    python3 lattice_max_ab.py --lib N=cs304_tpu_torch/csrc/trellis_lattice.cu \
        --lib P=parent.cu --order P,N,N,P [--shapes 58,503,...] [--simple] [--out FILE]

Each source is a version of ``csrc/trellis_lattice.cu`` (a parent commit's
from ``git show <commit>:cs304_tpu_torch/csrc/trellis_lattice.cu``, or an
edited copy) that nvcc compiles into a library of its own, printing ptxas'
registers and spills of its LMAX builds. At each shape every library's
outputs are held bitwise (signs of zero included) against
``lattice_max_passes_plain``, then each library's plan branch is timed in
the order given (device time of CUDA-graph replays, best of 5), printed as
µs a step; ``--simple`` adds the first library's first design
(``simple=1``) in turns beside its plan's branch (s n n s). Shapes: phase
31's, and a composite for each build of the team branch (as
``tests/test_torch_cuda_kernels.py`` LMAX_BUILDS). Needs a card and nvcc.
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
from cs304_tpu_torch.models.hmm import (  # noqa: E402
    WordHMM,
    flagship_composite,
    stack_word_models,
    uniform_forward_log_a,
)
from cs304_tpu_torch.ops.cuda import trellis_lattice as tlk  # noqa: E402

# name: (word state counts (None: the flagship), penalty, T, length)
SHAPES = {
    "58": (None, None, 201, 180), "58t59": (None, None, 59, 59),
    "single": ([1, 3, 1, 5, 1, 3], 0.0, 64, 40),
    "pool33": ([2, 1] * 16 + [3], -25.0, 40, 40),
    "375": ([5] * 75, -100.0, 201, 201), "503": ([5] * 100 + [3], -100.0, 201, 201),
    "1503": ([5] * 300 + [3], -100.0, 201, 201), "3003": ([5] * 600 + [3], -100.0, 100, 100),
    "5003": ([5] * 1000 + [3], -100.0, 60, 60), "8188": ([5] * 1637 + [3], -100.0, 30, 30),
    "long": ([250] * 20, -100.0, 150, 150),
    # The team branch's other builds (states a band thread, pool, cells a
    # lane, CTAs), and single-state words where the plan keeps the first design.
    "k1-cells2": ([2] * 300, -100.0, 64, 64), "700-single": ([1] * 700, -100.0, 64, 64),
    "k2-dense": ([50] * 30, -100.0, 100, 100), "k2-cells1": ([10] * 150, -100.0, 64, 64),
    "k2-cells4": ([2] * 700, -100.0, 64, 64), "1100-single": ([1] * 1100, -100.0, 64, 64),
    "k4-dense": ([100] * 30, -100.0, 100, 100), "k4-cells1": ([20] * 150, -100.0, 64, 64),
    "k4-cells2": ([7] * 400, -100.0, 64, 64), "k4-cells8": ([2] * 1100, -100.0, 64, 64),
    "c2-cells2": ([12] * 400, -100.0, 64, 64), "c2-cells8": ([4] * 1100, -100.0, 64, 64),
    "c4-long": ([400] * 20, -100.0, 216, 216), "c4-cells2": ([20] * 400, -100.0, 64, 64),
    "c4-cells4": ([8] * 1000, -100.0, 64, 64),
}


def build(name, path, workdir):
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
            cur = m[1] if "lattice_max" in m[1] else None
        elif cur and ("registers" in line or "spill" in line):
            info = re.sub(r".*:\s*", "", line.strip())
            res.append(re.sub(r".*lattice_max_", "", cur) + " " + info)
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cs304_lattice_max.argtypes = [p, p, p, p, p, f, i, p, p, p, p, i, i, i, i, i, p]
    lib.cs304_lattice_max.restype = i
    lib.cs304_lattice_max_plan.argtypes = [i, i, i, p]
    lib.cs304_lattice_max_plan.restype = i
    return name, lib, res


def composite(counts, penalty):
    if counts is None:
        return flagship_composite()
    rng = np.random.default_rng(31)
    return stack_word_models(
        [WordHMM(f"w{i}", rng.normal(size=(n, 4)).astype(np.float32),
                 np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)), uniform_forward_log_a(n))
         for i, n in enumerate(counts)], penalty=penalty)


def bits_equal(a, b):
    if a.dtype.is_floating_point:
        return torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))
    return torch.equal(a, b)


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", action="append", required=True, help="NAME=SOURCE.cu")
    ap.add_argument("--order", default=None, help="library names in timing order")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--simple", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lattice_max_ab: needs a card")
    libs = dict(x.split("=", 1) for x in args.lib)
    workdir = tempfile.mkdtemp(prefix="lattice_max_ab_")
    with ThreadPoolExecutor(len(libs)) as ex:
        built = list(ex.map(lambda kv: build(*kv, workdir), libs.items()))
    fns = {}
    for name, lib, res in built:
        print(name, "ptxas:", *res, sep="\n  ", flush=True)
        fns[name] = lib.cs304_lattice_max
    order = (args.order or ",".join(libs)).split(",")
    first = order[0]
    plan_of = dict((name, lib) for name, lib, _res in built)[first].cs304_lattice_max_plan
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for key in args.shapes.split(","):
        counts, pen, t, length = SHAPES[key]
        comp = composite(counts, pen)
        topo = tlk.lattice_topology(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                                    comp.word_of_state, device=dev)
        # Sources from before the pool's carry bit was dropped read bit 8 of
        # ints row 3 at the entries (every pool pick new); later ones ignore it.
        topo.ints[3] |= 8 * (topo.coefs[4] > 0).to(torch.int32)
        s = comp.num_states
        lb = 3 * torch.randn((t, s), generator=gen, device=dev)
        want = tlk.lattice_max_passes_plain(lb, topo, comp.penalty, length)
        outs = (torch.empty((t, s), device=dev), torch.empty((t, s), dtype=torch.int32, device=dev),
                torch.empty((t,), device=dev), torch.empty((), device=dev))

        def run(fn, simple):
            code = fn(lb.data_ptr(), topo.coefs.data_ptr(), topo.ints.data_ptr(),
                      topo.exits.data_ptr(), topo.entries.data_ptr(), float(comp.penalty),
                      int(length), *(o.data_ptr() for o in outs), t, s, topo.exits.numel(),
                      topo.entries.numel(), int(simple), torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"cs304_lattice_max returned {code}")

        equal = {}
        for name, fn in fns.items():
            for simple in (0, 1) if args.simple and name == first else (0,):
                run(fn, simple)
                torch.cuda.synchronize()
                equal[name + ("-simple" if simple else "")] = all(
                    bits_equal(g, w) for g, w in zip(outs, want))
        turns = [(n, 0) for n in order]
        if args.simple:
            turns = [(first, 1)] + turns + [(first, 1)]
        us = {}
        for name, simple in turns:
            ms = device_ms(lambda: run(fns[name], simple))
            us.setdefault(name + ("-simple" if simple else ""), []).append(
                round(ms / (t - 1) * 1e3, 4))
        plan = (ctypes.c_int * 7)()
        plan_of(s, topo.exits.numel(), topo.entries.numel(), plan)
        # (branch 0 team / 1 simple, states a band thread, dense, pool warps,
        # threads, cells a pool lane, CTAs) of the first library
        row = {"shape": key, "S": s, "T": t, "finite_score": bool(torch.isfinite(want[3])),
               "plan": list(plan),
               "equal": equal, "us_step": us}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if not all(all(r["equal"].values()) and r["finite_score"] for r in rows):
        raise SystemExit("lattice_max_ab: a library disagrees with the plain version")


if __name__ == "__main__":
    main()
