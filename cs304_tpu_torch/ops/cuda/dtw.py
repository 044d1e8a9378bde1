"""Multi-template DTW column recursion: wrapper of csrc/dtw.cu.

Replaces cs304_tpu/ops/dtw.py:dtw_multi_template (a lax.scan over the
sample's columns; no Pallas kernel). ONE launch runs every column of a
sample and gathers each word's last row; the kernel is bitwise its plain
version, ops/dtw.py:dtw_columns_plain.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The kernel takes 1 <= H <= MAX_TEMPLATE_ROWS template rows and
L >= 1 sample frames, with no shape fallback.
"""
from __future__ import annotations

import torch

from ..dtw import dtw_columns_plain
from . import _build
from .trellis_scanfree import _check_cuda

# 1024 threads of at most 8 rows each (csrc/dtw.cu).
MAX_TEMPLATE_ROWS = 8 * 1024

__all__ = ["MAX_TEMPLATE_ROWS", "dtw_columns"]


def dtw_columns(dist_t, is_first, is_second, end_rows, pruning: bool = True,
                pruning_factor: float = 4.0):
    """dist_t (L, H) float32 contiguous, is_first / is_second (H,) bool or
    uint8, end_rows (W,) int32 in [0, H) -> (W,) float32 costs."""
    if not dist_t.is_cuda:
        return dtw_columns_plain(dist_t, is_first, is_second, end_rows, pruning,
                                 pruning_factor)
    _check_cuda("dist_t", dist_t, torch.float32)
    if dist_t.dim() != 2:
        raise ValueError(f"dist_t must be (L, H), got {tuple(dist_t.shape)}")
    n_frames, h = dist_t.shape
    if not (1 <= h <= MAX_TEMPLATE_ROWS and n_frames >= 1):
        raise ValueError(f"dist_t {tuple(dist_t.shape)}: the kernel takes L >= 1 "
                         f"and 1 <= H <= {MAX_TEMPLATE_ROWS}")
    flags = []
    for name, flag in (("is_first", is_first), ("is_second", is_second)):
        if flag.dtype == torch.bool:
            flag = flag.view(torch.uint8)
        _check_cuda(name, flag, torch.uint8)
        if flag.shape != (h,):
            raise ValueError(f"{name} {tuple(flag.shape)} vs H = {h}")
        flags.append(flag)
    _check_cuda("end_rows", end_rows, torch.int32)
    if end_rows.dim() != 1:
        raise ValueError(f"end_rows must be (W,), got {tuple(end_rows.shape)}")
    if not (dist_t.device == flags[0].device == flags[1].device == end_rows.device):
        raise ValueError("dist_t, is_first, is_second and end_rows are on different devices")
    w = end_rows.shape[0]
    lib = _build.load()
    col = torch.empty((h,), dtype=torch.float32, device=dist_t.device)
    out = torch.empty((w,), dtype=torch.float32, device=dist_t.device)
    with torch.cuda.device(dist_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_dtw(
            dist_t.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(),
            end_rows.data_ptr(), col.data_ptr(), out.data_ptr(), h, n_frames, w,
            int(pruning), float(pruning_factor), stream,
        )
    _build.check(code, "dtw")
    dtw_columns.launches += 1
    return out


dtw_columns.launches = 0
