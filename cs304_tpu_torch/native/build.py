"""Build the native wavio library with the host C++ compiler (plain C ABI).

The library is built at first use into ``cs304_tpu_torch/_build/`` (ignored
by git), never beside the source, under a name keyed on a hash of the source
and flags, so an edited source rebuilds. It is written under a temporary name
and renamed, so concurrent builders (test workers) never load a half-written
file.
"""
from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "wavio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcs304wavio_{h.hexdigest()[:16]}.so"


def build() -> Path | None:
    """Compile wavio.cpp unless the current source is already built.
    Returns the library's path, or None when no compiler could build it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, out.name)
        cmd = [os.environ.get("CXX", "g++"), *FLAGS, str(SOURCE), "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError) as e:
            logger.warning("native build failed (%s); using Python fallbacks", e)
            return None
        os.replace(tmp, out)
    logger.info("built native library: %s", out)
    return out


if __name__ == "__main__":
    print(build())
