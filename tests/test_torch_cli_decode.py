"""The port's align, project6_interactive and adapt_speaker scripts
(``--device cpu``) against the JAX package's, run in process on one tiny
checkpoint: tests/test_cli_rich_decode.py's 3-word recipe (3, 5, 7) plus a
3-state silence model from the clips' endpointed noise, trained by the port
and saved by the JAX package, and one WAV of "375". project6_interactive
runs once beside JAX with --nbest, --confidence, --spot, --lattice-dot,
--consensus-net and a bigram --rescore-lm; its trigram rescoring over an
n-best lattice and --grammar-pattern run on the port alone (the JAX twins'
compilations would double this file's time) and must decode "375".

Printed words, labels, frames and integers are equal, line for line, and so
are the align CSV and the lattice's arcs. The numbers that are sums over the
utterance are held to tolerances:
- scores (|x| >= 100: alignment, n-best, rescoring and DOT arc scores) within
  rtol 1e-5 (ForcedAligner's parity tolerance, tests/test_torch_align.py)
  plus half a unit of the printed last digit;
- posteriors (confidences, keyword and confusion-network posteriors,
  eps) within 4 float32 ulps of the utterance's |log Z| plus the print's
  rounding (0.001): each is exp(... - log Z), which moves in steps of
  log Z's ulp (2^-8 here; tests/test_torch_cli_transcribe.py).
The adapted checkpoint's means are within test_torch_adapt.py's rtol 1e-5 /
atol 1e-5 of JAX's, its other arrays equal.
"""
import re

import numpy as np
import pytest

from cs304_tpu_torch.scripts._common import run_in_process
from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_cli_transcribe import jax_main, log_z_ulps, port_main, train_tiny


CONF_ULPS = 4
SCORE_RTOL = 1e-5
PROB_LINES = ("confidence", "posterior", "slot")
CASES = {
    "align": ("align", ["--transcript", "375", "--states", "--csv-out", "{d}/align.csv"]),
    "rich": ("project6_interactive", [
        "--nbest", "3", "--confidence", "--spot", "7", "--lattice-dot", "{d}/forward.dot",
        "--consensus-net", "--rescore-lm", "{tmp}/lm.txt"]),
    "adapt": ("adapt_speaker", ["--transcript", "375", "--tau", "10", "--out-dir", "{d}/adapted"]),
}
PORT_ONLY = {
    "trigram": ["--rescore-lm", "{tmp}/lm.txt", "--lm-order", "3", "--lattice-method", "nbest",
                "--lattice-dot", "{d}/nbest.dot"],
    "grammar_pattern": ["--grammar-pattern", "37:*:*"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from cs304_tpu.audio.wav import write_wav_int16
    from cs304_tpu.data.synthetic import SyntheticTIDigits

    tmp = tmp_path_factory.mktemp("cli_decode")
    corpus = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1, takes_per_digit=2)
    wav = str(tmp / "utt375.wav")
    write_wav_int16(wav, corpus.sentence_audio("375", 0, jitter_seed=3), 16000)
    from cs304_tpu.utils.checkpoint import save_models

    ckpt = str(tmp / "ckpt")
    save_models(train_tiny(corpus, with_silence=True), ckpt)
    (tmp / "lm.txt").write_text("375\n357\n573\n")
    base = ["--checkpoint-dir", ckpt, "--wav", wav, "--log-file", str(tmp / "rt.log")]
    out = {}
    for what, (script, opts) in CASES.items():
        for pkg, get in (("jax", jax_main), ("port", port_main)):
            d = tmp / pkg
            d.mkdir(exist_ok=True)
            argv = base + [o.format(d=d, tmp=tmp) for o in opts]
            out[what, pkg] = run_in_process(get(script), argv).replace(str(d), "<out>")
    for what, opts in PORT_ONLY.items():
        out[what] = run_in_process(port_main("project6_interactive"),
                                   base + [o.format(d=tmp / "port", tmp=tmp) for o in opts])
    return {"out": out, "tmp": tmp, "ulp": log_z_ulps(ckpt, [wav])[0]}


def same_up_to_tolerance(got, want, prob_tol):
    """got and want line for line: the text between numbers equal, integers
    equal, scores and posteriors within their tolerances."""
    got_lines, want_lines = got.strip().splitlines(), want.strip().splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(got_lines, want_lines):
        g_parts, w_parts = re.split(r"(-?\d+\.\d+)", g), re.split(r"(-?\d+\.\d+)", w)
        assert g_parts[::2] == w_parts[::2], (g, w)
        for gs, ws in zip(g_parts[1::2], w_parts[1::2]):
            gv, wv = float(gs), float(ws)
            half_unit = 0.5 * 10.0 ** -len(ws.split(".")[1])
            if abs(wv) >= 100:
                assert abs(gv - wv) <= SCORE_RTOL * abs(wv) + 2 * half_unit, (g, w)
            elif any(k in w for k in PROB_LINES):
                assert abs(gv - wv) <= prob_tol, (g, w, prob_tol)
            else:
                assert gs == ws, (g, w)


@pytest.mark.parametrize("what", CASES)
def test_script_equals_jax(runs, what):
    prob_tol = CONF_ULPS * runs["ulp"] + 0.001
    same_up_to_tolerance(runs["out"][what, "port"], runs["out"][what, "jax"], prob_tol)
    out = runs["out"][what, "port"]
    if what == "align":
        words = [ln.split()[0] for ln in out.splitlines()[1:]
                 if "frames" in ln and "state" not in ln]
        assert words == ["3", "7", "5"]
    if what == "rich":
        assert "375" in out.splitlines()[0]
        assert "consensus-net: 375" in out and "posterior" in out


def test_port_only_interactive_options(runs):
    assert runs["out"]["grammar_pattern"] == "decoded: 375\n"
    lines = runs["out"]["trigram"].splitlines()
    assert lines[0] == "decoded: 375" and lines[1].startswith("lattice: ")
    assert lines[2].startswith("rescored: 375  (score ") and "order 3" in lines[2]


def test_written_files_equal_jax(runs):
    tmp = runs["tmp"]
    prob_tol = CONF_ULPS * runs["ulp"] + 0.001
    assert (tmp / "port" / "align.csv").read_text() == (tmp / "jax" / "align.csv").read_text()
    got = (tmp / "port" / "forward.dot").read_text()
    assert got.startswith("digraph") and "->" in got
    same_up_to_tolerance(got, (tmp / "jax" / "forward.dot").read_text(), prob_tol)


def test_adapted_models_equal_jax(runs):
    from cs304_tpu.utils.checkpoint import load_manifest as jax_manifest
    from cs304_tpu.utils.checkpoint import load_models as jax_load
    from cs304_tpu_torch.utils.checkpoint import load_manifest, load_models

    tmp = runs["tmp"]
    got, want = load_models(str(tmp / "port" / "adapted")), jax_load(str(tmp / "jax" / "adapted"))
    assert sorted(got) == sorted(want) == ["3", "5", "7", "S"]
    for label in want:
        np.testing.assert_allclose(got[label].means, want[label].means, rtol=1e-5, atol=1e-5,
                                   err_msg=label)
        np.testing.assert_array_equal(got[label].covariances, want[label].covariances)
        np.testing.assert_array_equal(got[label].log_a, want[label].log_a)
    manifests = [m(str(tmp / pkg / "adapted")) for m, pkg in ((load_manifest, "port"),
                                                              (jax_manifest, "jax"))]
    for m in manifests:
        m["provenance"].pop("source")
    assert manifests[0] == manifests[1]
