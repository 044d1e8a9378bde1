"""Profiling hooks: wall-clock phase timers + torch.profiler device traces.

The counterpart of cs304_tpu/utils/profiling.py: `phase_timer` for cheap
host-side timings (synchronizing the card when asked to, where JAX blocks
on the array) and `device_trace` wrapping torch.profiler, so a Chrome trace
of any region (CPU activity, plus the card's kernels when it runs on one)
is captured with one line.
"""
from __future__ import annotations

import logging
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Dict

import torch

logger = logging.getLogger(__name__)

_TIMINGS: Dict[str, float] = {}


def _on_card(tree) -> bool:
    """True when a tensor of ``tree`` (a tensor, or a list / tuple / dict of
    them, nested) lies on a CUDA device."""
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_card(t) for t in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_card(t) for t in tree)
    return False


@contextmanager
def phase_timer(name: str, sync=None):
    """Times a region; pass sync=tensor (or a list / tuple / dict of them)
    to wait for the card's work before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None and _on_card(sync):
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _TIMINGS[name] = _TIMINGS.get(name, 0.0) + dt
        logger.info("phase %s: %.3fs", name, dt)


def timings() -> Dict[str, float]:
    return dict(_TIMINGS)


def reset_timings() -> None:
    _TIMINGS.clear()


@contextmanager
def device_trace(log_dir: str | None = None):
    """Capture a torch.profiler trace of the region (CPU activity, and CUDA
    activity when a card is present) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto); log_dir defaults
    to ``cs304_tpu_trace`` under the temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "cs304_tpu_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
