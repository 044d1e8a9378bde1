"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by nvcc for ``sm_90a`` (one nvcc process
per source, all started together) and linked into ONE shared library with a
plain C interface, loaded with ctypes. The library is built at first use
into ``cs304_tpu_torch/_build/`` (ignored by git) under a name keyed on a
hash of the sources and flags, so an edited source rebuilds; it is written
under a temporary name and renamed, so concurrent builders never see a
half-written file. A failed build raises with nvcc's output: there is no
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
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        for src in sources():
            if src.suffix != ".cu":
                continue
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = [proc.communicate()[0] for _c, _o, proc in jobs]  # wait for all
        for (cmd, _obj, proc), log in zip(jobs, logs):
            _raise_on_failure(proc.returncode, cmd, log)
        tmp = os.path.join(work, out.name)
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _c, obj, _p in jobs]]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        _raise_on_failure(proc.returncode, cmd, proc.stdout)
        out.with_suffix(".log").write_text("".join(logs) + proc.stdout)
        os.replace(tmp, out)
    return out


def _raise_on_failure(code: int, cmd, log: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed (rc={code}): {' '.join(cmd)}\n{log}")


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cs304_emission_quad.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.cs304_emission_quad.restype = i
        lib.cs304_trellis_forward.argtypes = [p, p, f, p, p, p, i, i, i, i, p]
        lib.cs304_trellis_forward.restype = i
        lib.cs304_trellis_decode.argtypes = [p, p, f, p, p, p, p, i, i, i, i, i, p]
        lib.cs304_trellis_decode.restype = i
        lib.cs304_trellis_decode_scratch_bytes.argtypes = [i, i, i, i]
        lib.cs304_trellis_decode_scratch_bytes.restype = ctypes.c_longlong
        lib.cs304_trellis_lm_table.argtypes = [i, i, i, i]
        lib.cs304_trellis_lm_table.restype = i
        lib.cs304_trellis_backtrace.argtypes = [p, i, ctypes.c_longlong, p, p, p,
                                                i, i, i, i, p]
        lib.cs304_trellis_backtrace.restype = i
        lib.cs304_trellis_backtrace_max_states.argtypes = [i, p]
        lib.cs304_trellis_backtrace_max_states.restype = i
        lib.cs304_trellis_stream.argtypes = [p, p, i, p, p, p, p, p, f,
                                             i, i, i, i, i, i, p]
        lib.cs304_trellis_stream.restype = i
        lib.cs304_trellis_search_decode.argtypes = [p, p, f, p, p, p, i, f, i, p, p, p, p,
                                                    i, i, i, i, i, p]
        lib.cs304_trellis_search_decode.restype = i
        lib.cs304_trellis_stream_lm.argtypes = [p, p, i, p, p, p, p, p, p, p, p, i,
                                                i, i, i, i, i, i, p]
        lib.cs304_trellis_stream_lm.restype = i
        lib.cs304_trellis_sentence_forward.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
        lib.cs304_trellis_sentence_forward.restype = i
        lib.cs304_trellis_sentence_decode.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p]
        lib.cs304_trellis_sentence_decode.restype = i
        lib.cs304_trellis_dense_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.cs304_trellis_dense_forward.restype = i
        lib.cs304_trellis_dense_branch.argtypes = [i]
        lib.cs304_trellis_dense_branch.restype = i
        lib.cs304_trellis_fb.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p]
        lib.cs304_trellis_fb.restype = i
        lib.cs304_trellis_fb_posteriors.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p]
        lib.cs304_trellis_fb_posteriors.restype = i
        lib.cs304_emission_split.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.cs304_emission_split.restype = i
        lib.cs304_emission_split_stages.argtypes = [i, i, i, i]
        lib.cs304_emission_split_stages.restype = i
        lib.cs304_dtw.argtypes = [p, i, p, p, p, p, i, i, i, i, f, p]
        lib.cs304_dtw.restype = i
        lib.cs304_trellis_planes.argtypes = [p, p, p, p, p, p, p, p, f, i, i, i, i, i, i, i,
                                             p, p, p, p, i, p, p]
        lib.cs304_trellis_planes.restype = i
        lib.cs304_trellis_planes_scratch_bytes.argtypes = [i, i, i, i, i, i]
        lib.cs304_trellis_planes_scratch_bytes.restype = ctypes.c_longlong
        lib.cs304_trellis_duration.argtypes = [p, p, p, p, p, f, i, i, i, i, i, i,
                                               p, p, p, p, i, p, p]
        lib.cs304_trellis_duration.restype = i
        lib.cs304_trellis_duration_scratch_bytes.argtypes = [i, i, i, i, i]
        lib.cs304_trellis_duration_scratch_bytes.restype = ctypes.c_longlong
        lib.cs304_trellis_planes_plan.argtypes = [i, i, i, p]
        lib.cs304_trellis_planes_plan.restype = i
        lib.cs304_trellis_duration_plan.argtypes = [i, i, i, p]
        lib.cs304_trellis_duration_plan.restype = i
        lib.cs304_trellis_team_instance.argtypes = [i, i, i, i, f, i, p]
        lib.cs304_trellis_team_instance.restype = i
        lib.cs304_trellis_planes_team.argtypes = [p, p, p, p, p, p, p, p, f, i, i, i, i, i, i,
                                                  i, p, p, i, p, p]
        lib.cs304_trellis_planes_team.restype = i
        lib.cs304_trellis_duration_team.argtypes = [p, p, p, p, f, i, i, i, i, i, i, p, p, i,
                                                    p, p]
        lib.cs304_trellis_duration_team.restype = i
        lib.cs304_lattice_sum.argtypes = [p, p, p, p, p, p, f, p, p, p, p, i, i, i, i, i, i, p]
        lib.cs304_lattice_sum.restype = i
        lib.cs304_lattice_sum_plan.argtypes = [i, i, i, p]
        lib.cs304_lattice_sum_plan.restype = i
        lib.cs304_lattice_dense_pool_max.argtypes = []
        lib.cs304_lattice_dense_pool_max.restype = i
        lib.cs304_lattice_max.argtypes = [p, p, p, p, p, f, i, p, p, p, p, i, i, i, i, i, p]
        lib.cs304_lattice_max.restype = i
        lib.cs304_lattice_max_plan.argtypes = [i, i, i, p]
        lib.cs304_lattice_max_plan.restype = i
        lib.cs304_kbest_scratch_words.argtypes = [i, i]
        lib.cs304_kbest_scratch_words.restype = ctypes.c_longlong
        lib.cs304_lattice_skeleton.argtypes = [i, i, i, i, i, p, p]
        lib.cs304_lattice_skeleton.restype = i
        lib.cs304_lattice_cluster_skeleton.argtypes = [i, i, i, p, p]
        lib.cs304_lattice_cluster_skeleton.restype = i
        lib.cs304_kbest_plan.argtypes = [i, i, i, p]
        lib.cs304_kbest_plan.restype = i
        lib.cs304_kbest_forward.argtypes = [p, p, p, f, i, i, p, p, p, i, i, i, i, p]
        lib.cs304_kbest_forward.restype = i
        lib.cs304_fb_dense.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, p]
        lib.cs304_fb_dense.restype = i
        lib.cs304_fb_dense_max_states.argtypes = []
        lib.cs304_fb_dense_max_states.restype = i
        lib.cs304_fb_dense_plan.argtypes = [i]
        lib.cs304_fb_dense_plan.restype = i
        lib.cs304_fb_dense_build_shape.argtypes = [i, p]
        lib.cs304_fb_dense_build_shape.restype = i
        lib.cs304_fb_dense_on.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, i, i, i, p]
        lib.cs304_fb_dense_on.restype = i
        lib.cs304_error_string.argtypes = [i]
        lib.cs304_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = load().cs304_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
