"""Multi-template DTW column recursion: wrapper of csrc/dtw.cu.

Replaces cs304_tpu/ops/dtw.py:dtw_multi_template (a lax.scan over the
sample's columns; no Pallas kernel). ONE launch runs every column of a
sample and gathers each word's last row; the kernel is bitwise its plain
version, ops/dtw.py:dtw_columns_plain.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. The kernel takes 1 <= H <= MAX_TEMPLATE_ROWS template rows and
L >= 1 sample frames, with no shape fallback. It moves each column into
shared memory with bulk copies of 16-byte rows, so it reads the rows at a
stride that is a multiple of 4 floats from a 16-byte-aligned start: any
other (L, H) layout with unit column stride (a contiguous one whose H is
not a multiple of 4, say) is first copied to such a stride
(``aligned_rows``; ``DTWRecognizer.distances`` writes its distances there).
"""
from __future__ import annotations

import torch

from ..dtw import dtw_columns_plain
from . import _build
from .trellis_scanfree import _check_cuda

# 16 warps of 64 rows a lane (csrc/dtw.cu).
MAX_TEMPLATE_ROWS = 32 * 1024

__all__ = ["MAX_TEMPLATE_ROWS", "aligned_rows", "dtw_columns"]


def aligned_rows(n_frames: int, h: int, device) -> torch.Tensor:
    """An uninitialized (n_frames, h) float32 view whose rows start 16 bytes
    apart or a multiple of that (stride h rounded up to 4), as the column
    kernel reads them without a copy."""
    ld = (h + 3) // 4 * 4
    return torch.empty((n_frames, ld), dtype=torch.float32, device=device)[:, :h]


def _bulk_readable(dist_t) -> bool:
    """Whether the kernel's bulk copies can read dist_t's rows in place: a
    16-byte-aligned start, a row stride that is a multiple of 4 floats and
    at least H, and storage past the last row's H rounded up to 4."""
    n_frames, h = dist_t.shape
    ld = dist_t.stride(0)
    end = dist_t.storage_offset() + (n_frames - 1) * ld + (h + 3) // 4 * 4
    return (dist_t.data_ptr() % 16 == 0 and ld % 4 == 0 and ld >= h
            and end * 4 <= dist_t.untyped_storage().nbytes())


def dtw_columns(dist_t, is_first, is_second, end_rows, pruning: bool = True,
                pruning_factor: float = 4.0):
    """dist_t (L, H) float32 with unit column stride (contiguous, or a view of
    ``aligned_rows``), is_first / is_second (H,) bool or uint8, end_rows (W,)
    int32 in [0, H) -> (W,) float32 costs."""
    if not dist_t.is_cuda:
        return dtw_columns_plain(dist_t, is_first, is_second, end_rows, pruning,
                                 pruning_factor)
    if dist_t.dtype != torch.float32:
        raise TypeError(f"dist_t must be {torch.float32}, got {dist_t.dtype}")
    if dist_t.dim() != 2:
        raise ValueError(f"dist_t must be (L, H), got {tuple(dist_t.shape)}")
    n_frames, h = dist_t.shape
    if not (1 <= h <= MAX_TEMPLATE_ROWS and n_frames >= 1):
        raise ValueError(f"dist_t {tuple(dist_t.shape)}: the kernel takes L >= 1 "
                         f"and 1 <= H <= MAX_TEMPLATE_ROWS = {MAX_TEMPLATE_ROWS}")
    if dist_t.stride(1) != 1 or (n_frames > 1 and dist_t.stride(0) < h):
        raise ValueError(f"dist_t must have unit column stride and rows of at least H "
                         f"apart, got strides {dist_t.stride()}")
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
    if not _bulk_readable(dist_t):
        dist_t = aligned_rows(n_frames, h, dist_t.device).copy_(dist_t)
    w = end_rows.shape[0]
    lib = _build.load()
    out = torch.empty((w,), dtype=torch.float32, device=dist_t.device)
    with torch.cuda.device(dist_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.cs304_dtw(
            dist_t.data_ptr(), dist_t.stride(0), flags[0].data_ptr(), flags[1].data_ptr(),
            end_rows.data_ptr(), out.data_ptr(), h, n_frames, w, int(pruning),
            float(pruning_factor), stream,
        )
    _build.check(code, "dtw")
    dtw_columns.launches += 1
    return out


dtw_columns.launches = 0
