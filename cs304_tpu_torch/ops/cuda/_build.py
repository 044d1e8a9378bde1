"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by nvcc for ``sm_90a`` into ONE shared
library with a plain C interface, loaded with ctypes. The library is built at
first use into ``cs304_tpu_torch/_build/`` (ignored by git) under a name keyed
on a hash of the sources and flags, so an edited source rebuilds; it is
written under a temporary name and renamed, so concurrent builders never see
a half-written file. A failed build raises with nvcc's output: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib = None


def sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcs304_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the kernels unless the current sources are already built.
    Returns the library's path; nvcc's log (register and shared-memory use
    per kernel) is kept beside it as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[str(s) for s in sources()
                                               if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cs304_emission_quad.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.cs304_emission_quad.restype = i
        lib.cs304_trellis_forward.argtypes = [p, p, f, p, p, p, i, i, i, i, p]
        lib.cs304_trellis_forward.restype = i
        lib.cs304_trellis_backtrace.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.cs304_trellis_backtrace.restype = i
        lib.cs304_error_string.argtypes = [i]
        lib.cs304_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = load().cs304_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
