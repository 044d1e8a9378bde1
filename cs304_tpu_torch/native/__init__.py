"""Native (C++) runtime tier: WAV decode, frame energies, endpointing.

A copy of the JAX package's native tier. libcs304wavio is built from
wavio.cpp with the host compiler at the first call that needs it (build.py,
into cs304_tpu_torch/_build/) and loaded via ctypes. Every entry point has a
pure-Python/scipy fallback; ``HAS_NATIVE`` says which path runs (reading it
builds the library if it is not built yet).
"""
from . import loader
from .loader import (
    has_native,
    native_endpoint_feed,
    native_endpoint_frames,
    native_frame_energies,
    native_read_wav,
)

__all__ = [
    "HAS_NATIVE",
    "has_native",
    "native_read_wav",
    "native_frame_energies",
    "native_endpoint_frames",
    "native_endpoint_feed",
]


def __getattr__(name):
    if name == "HAS_NATIVE":
        return loader.has_native()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
