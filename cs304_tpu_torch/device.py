"""Device selection and float32 precision pinning.

Nothing moves to the CPU silently: the default is the card, and asking for a
CUDA device on a host without one raises. The CPU runs only when the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"auto"`` -> the first card; anything else is taken
    literally. A CUDA device (the default included) without a card raises."""
    dev = torch.device("cuda", 0) if device is None or device == "auto" else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False (no card, or a CPU-only PyTorch build)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def upload(array, device: torch.device) -> torch.Tensor:
    """A host NumPy array as a new tensor on ``device``, never aliasing the
    array (the caller may reuse it at once). To a card it is a non-blocking
    copy from pageable memory: the driver stages the bytes before the call
    returns, and the host does not wait for the work already queued on the
    stream (a blocking copy synchronizes it; staging through pinned memory
    cost more host time a step, measured on the card in `PERF.md` §6 PR 7)."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(array, copy=True))
    return torch.from_numpy(np.ascontiguousarray(array)).to(device, non_blocking=True)


def upload_ints(arrays, device: torch.device, dtype=np.int64):
    """Several host integer arrays in ONE upload, as contiguous ``dtype``
    views on ``device`` (one copy, not one per array)."""
    flat = [np.asarray(a, dtype).ravel() for a in arrays]
    packed = upload(np.concatenate(flat), device)
    out, at = [], 0
    for a, f in zip(arrays, flat):
        out.append(packed[at: at + len(f)].view(np.shape(a)))
        at += len(f)
    return out


def fp32_exact() -> None:
    """Full float32 matmuls and convolutions (no TF32), the counterpart of the
    JAX package's Precision.HIGHEST. Called by every op that multiplies
    float32 matrices, so the setting never depends on a process default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
