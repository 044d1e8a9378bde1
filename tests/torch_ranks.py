"""A group of gloo ranks on the CPU for the port's data-parallel tests.

``run_ranks(cases, payload, world, folder)`` spawns ``world`` processes
(torch.multiprocessing, start method "spawn"), joins them into one gloo
process group through a ``file://`` store in ``folder`` (no TCP port, so
parallel test workers cannot clash), builds the port's mesh over it and runs
every case, ``case(mesh, payload) -> result``, in every rank, in order.
Returns each rank's results, ``[{case name: result}, ...]``.

The cases must be importable in a child without JAX: they live in modules
that import neither ``jax`` nor ``cs304_tpu`` at module level. Each rank runs
torch on one thread. A hung collective times out after ``COLLECTIVE_S``
seconds inside the rank; the parent kills any rank still running after
``deadline`` seconds, so a fault fails the tests in about a minute.
"""
from __future__ import annotations

import os
import pickle
import time
import traceback
from datetime import timedelta

COLLECTIVE_S = 60


def _rank_main(rank, world, folder, cases):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {}
    try:
        with open(os.path.join(folder, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(folder, 'store')}",
            rank=rank, world_size=world, timeout=timedelta(seconds=COLLECTIVE_S))
        from cs304_tpu_torch.parallel.data_parallel import make_mesh

        mesh = make_mesh(device_type="cpu")
        for case in cases:
            out[case.__name__] = case(mesh, payload)
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the parent, which raises it
        out = {"error": traceback.format_exc()}
    with open(os.path.join(folder, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(cases, payload, world: int, folder, deadline: float = 150.0):
    import torch.multiprocessing as mp

    folder = str(folder)
    os.makedirs(folder, exist_ok=True)
    # Through a file: a spawn pipe larger than its buffer would hold each
    # start() until that child has imported torch, one rank after another.
    with open(os.path.join(folder, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(_rank_main, args=(world, folder, list(cases)),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(0.0, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"{world} ranks still running after {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for rank in range(world):
        with open(os.path.join(folder, f"rank{rank}.pkl"), "rb") as f:
            res = pickle.load(f)
        if "error" in res:
            raise RuntimeError(f"rank {rank} failed:\n{res['error']}")
        results.append(res)
    return results


def same_bits(a, b) -> bool:
    """a and b equal bit for bit: arrays by dtype, shape and bytes (so NaN
    and the sign of zero count), containers element by element."""
    import numpy as np

    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_bits(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b
