"""cs304_tpu_torch stands alone: it imports neither jax nor cs304_tpu.

A fresh interpreter blocks both (``sys.modules[name] = None`` makes any
import of them raise), imports every module of the port and runs a tiny CPU
decode through the raw-audio entry point.
"""
import os
import subprocess
import sys

_CODE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["cs304_tpu"] = None
import numpy as np
import cs304_tpu_torch
for mod in pkgutil.walk_packages(cs304_tpu_torch.__path__, "cs304_tpu_torch."):
    importlib.import_module(mod.name)
from cs304_tpu_torch.data.batching import make_signals
from cs304_tpu_torch.models import ContinuousDecoder, flagship_models
dec = ContinuousDecoder(flagship_models(), penalty=-100.0, emissions="quad",
                        backend="scanfree", device="cpu")
out = dec.predict_signal_batch(list(make_signals(2, 0.5)))
assert len(out) == 2 and all(isinstance(s, str) for s in out), out
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith(("jax.", "cs304_tpu.")))
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ISOLATED-OK")
"""


def test_port_imports_no_jax_and_decodes():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CODE], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED-OK" in proc.stdout
