"""Every port script against its JAX twin at the command-line surface.

For each of the 21 scripts (``scripts/_common.py`` aside): ``--help``
prints the usage and exits 0 in process, and the parser's options equal the
JAX script's, option for option (strings, dest, default, type, choices,
nargs, required, action), except that ``--device`` takes the place of
``--platform``. The PortAudio-only scripts (record, play_all, mic_testing,
project1_segment and the live loop of project4_interactive) are held by
their error without ``sounddevice``, which must be the JAX scripts' error.
The JAX scripts are loaded by path with ``scripts/`` on sys.path, so that
their ``_common`` import resolves; nothing in ``scripts/`` changes.
"""
import argparse
import contextlib
import importlib
import io
import os
import sys

import pytest

from cs304_tpu_torch.scripts._common import run_in_process
from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_cli_transcribe import jax_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "scripts"))
                 if f.endswith(".py") and f != "_common.py")
PORTAUDIO_ONLY = ("record", "play_all", "mic_testing")


def port_script(name):
    return importlib.import_module(f"cs304_tpu_torch.scripts.{name}")


class _Parsed(Exception):
    pass


def parser_of(call, monkeypatch):
    """The ArgumentParser that ``call`` builds, caught at parse_args."""
    seen = {}

    def caught(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", caught)
        with pytest.raises(_Parsed):
            call()
    return seen["parser"]


def options(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        key = tuple("--device" if s == "--platform" else s for s in a.option_strings)
        fields = (a.dest, a.default, a.type, a.choices, a.nargs, a.required, type(a))
        if key == ("--device",):
            fields = None  # --platform's choices and dest are JAX's own
        out[key] = fields
    return out


def test_every_script_ported():
    port = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "cs304_tpu_torch", "scripts"))
                  if f.endswith(".py") and not f.startswith("__"))
    assert port == sorted(SCRIPTS + ["_common"])
    assert len(SCRIPTS) == 21


@pytest.mark.parametrize("name", SCRIPTS)
def test_help_and_options_equal_jax(name, monkeypatch):
    port = port_script(name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as info:
        port.main(["--help"])
    assert info.value.code == 0
    assert out.getvalue().startswith("usage:")
    jax_parser = parser_of(lambda: jax_main(name)([]), monkeypatch)
    got = options(parser_of(lambda: port.main([]), monkeypatch))
    assert got == options(jax_parser)
    uses_common = ("--platform",) in {tuple(a.option_strings) for a in jax_parser._actions}
    assert uses_common == (name not in PORTAUDIO_ONLY)


@pytest.mark.parametrize("name", PORTAUDIO_ONLY + ("project1_segment", "project4_interactive"))
def test_portaudio_error_equals_jax(name, monkeypatch, tmp_path):
    """Without sounddevice each script stops with the JAX script's error
    (scripts/record.py:23-25; Segmentation's RuntimeError for the
    endpointing demo and project4_interactive's live loop, the latter on a
    checkpoint of the flagship's models)."""
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    monkeypatch.chdir(tmp_path)
    extra = [] if name in PORTAUDIO_ONLY else ["--log-file", str(tmp_path / "rt.log")]
    if name == "project4_interactive":
        from cs304_tpu_torch.models.hmm import flagship_models
        from cs304_tpu_torch.utils.checkpoint import save_models

        save_models(flagship_models(), str(tmp_path / "ckpt"))
        extra += ["--checkpoint-dir", str(tmp_path / "ckpt")]
    errors = []
    for call in (lambda: jax_main(name)(extra),
                 lambda: port_script(name).main(extra + (["--device", "cpu"] if extra else []))):
        with pytest.raises((SystemExit, RuntimeError)) as info:
            run_in_process(lambda _argv: call(), None)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]
    if name in PORTAUDIO_ONLY:
        assert errors[1][1].startswith("sounddevice unavailable:")
    else:
        assert "sounddevice" in errors[1][1]
