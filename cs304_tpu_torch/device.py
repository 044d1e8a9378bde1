"""Device selection and float32 precision pinning.

Nothing moves to the CPU silently: the default is the card, and asking for a
CUDA device on a host without one raises. The CPU runs only when the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

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


def fp32_exact() -> None:
    """Full float32 matmuls and convolutions (no TF32), the counterpart of the
    JAX package's Precision.HIGHEST. Called by every op that multiplies
    float32 matrices, so the setting never depends on a process default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
