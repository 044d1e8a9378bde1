"""The port's evaluation scripts (``--device cpu``) against the JAX
package's, run in process on the TI-Digits tree of
tests/test_torch_cli_train.py: validate_corpus, project3_predict and its
confusion-matrix plots, project4_synthetic_digits,
project5_find_trans_penalty and its plot, and project4_interactive --wav
(isolated and --continuous).

Both decode one checkpoint: the port's project5_train_no_empty +
project6_train on the tree, saved by the port and again by the JAX package
(each script reads its own package's save). Every printed line is equal, and
every plot file is equal byte for byte: a confusion matrix fixes each
(truth, prediction) pair count, so equal PNGs mean equal labels per class.
The demos and train_phones have their own files
(tests/test_torch_cli_demos.py, tests/test_torch_cli_phones.py), as
project5_test_ndigits has (tests/test_torch_cli_ndigits.py).
"""
import os

import pytest

from cs304_tpu_torch.scripts._common import run_in_process
from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_cli_train import EMBEDDED, KMEANS, shared_tree
from test_torch_cli_transcribe import jax_main, port_main

PACKAGES = (("jax", jax_main), ("port", port_main))
_CHECKPOINTS = {}


def port_checkpoint(tmp, root, log):
    """project5_train_no_empty then project6_train by the port on the
    tree: the embedded checkpoint's folder."""
    ck5, ck6 = str(tmp / "ck5"), str(tmp / "ck6")
    run_in_process(port_main("project5_train_no_empty"), [
        "--data-root", root, "--checkpoint-dir", ck5, *KMEANS, *log])
    run_in_process(port_main("project6_train"), [
        "--data-root", root, "--checkpoint-dir", ck5, "--out-dir", ck6, *EMBEDDED, *log])
    return ck6


def shared_checkpoint(tmp_path_factory):
    """The tree, and port_checkpoint on it saved by each package:
    {"root", "log", "jax", "port"} (checkpoint folders by package). Built
    once in a process; the files that use it share it when they run in
    one."""
    if not _CHECKPOINTS:
        from cs304_tpu.utils.checkpoint import save_models as jax_save
        from cs304_tpu_torch.utils.checkpoint import load_manifest, load_models

        root = shared_tree(tmp_path_factory)
        tmp = tmp_path_factory.mktemp("cli_checkpoint")
        log = ["--log-file", str(tmp / "rt.log")]
        port = port_checkpoint(tmp, root, log)
        jax_save(load_models(port), str(tmp / "ck6_jax"),
                 frontend=load_manifest(port).get("frontend"))
        _CHECKPOINTS.update(root=root, log=log, port=port, jax=str(tmp / "ck6_jax"))
    return _CHECKPOINTS


def run_twins(script, argv, ck, cwd=None):
    """``script`` by each package on ``argv`` (a list, "{ck}" standing for
    the package's checkpoint), in ``cwd/<package>`` when given: the printed
    lines by package, each checkpoint path written "<ck>"."""
    out = {}
    for pkg, get in PACKAGES:
        here = os.getcwd()
        if cwd is not None:
            os.makedirs(cwd / pkg)
            os.chdir(cwd / pkg)
        try:
            printed = run_in_process(get(script), [a.format(ck=ck[pkg]) for a in argv]
                                     + ck["log"])
        finally:
            os.chdir(here)
        out[pkg] = printed.replace(ck[pkg], "<ck>")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from cs304_tpu_torch.audio.wav import write_wav_int16
    from cs304_tpu_torch.data.synthetic import SyntheticTIDigits

    ck = shared_checkpoint(tmp_path_factory)
    tmp = tmp_path_factory.mktemp("cli_tools")
    corpus = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1, takes_per_digit=2)
    wav = str(tmp / "utt375.wav")
    write_wav_int16(wav, corpus.sentence_audio("375", 1, jitter_seed=9), 16000)
    data = ["--data-root", ck["root"], "--checkpoint-dir", "{ck}"]
    out = {
        "validate_corpus": run_twins("validate_corpus", ["--data-root", ck["root"]], ck),
        # The plots go to ./plots: one folder for each package.
        "project3_predict": run_twins("project3_predict", data, ck, cwd=tmp / "p3"),
        "project4_synthetic_digits": run_twins("project4_synthetic_digits",
                                               data + ["--num-samples", "5"], ck),
        "project5_find_trans_penalty": run_twins("project5_find_trans_penalty", data + [
            "--stop", "-200", "--step", "-100", "--max-per-label", "2"], ck, cwd=tmp / "p5"),
        "project4_interactive": run_twins("project4_interactive",
                                          ["--checkpoint-dir", "{ck}", "--wav", wav], ck),
        "project4_continuous": run_twins("project4_interactive",
                                         ["--checkpoint-dir", "{ck}", "--wav", wav,
                                          "--continuous"], ck),
    }
    return {"tmp": tmp, "out": out}


@pytest.mark.parametrize("what, lines", [
    ("validate_corpus", 8),
    ("project3_predict", 2),
    ("project4_synthetic_digits", 2),
    ("project5_find_trans_penalty", 3),
    ("project4_interactive", 1),
    ("project4_continuous", 1),
])
def test_evaluation_script_equals_jax(runs, what, lines):
    got, want = runs["out"][what]["port"], runs["out"][what]["jax"]
    assert got == want
    assert len(got.strip().splitlines()) >= lines, got


def test_evaluation_scripts(runs):
    out = {k: v["port"] for k, v in runs["out"].items()}
    assert out["validate_corpus"].strip().endswith("corpus looks usable")
    assert "train split: 92 clips, 23 labels (11 single-digit, 12 multi-digit)" in \
        out["validate_corpus"]
    assert out["project3_predict"].splitlines()[1].endswith("(22 clips)")
    assert out["project4_continuous"] == "predicted: 375\n"


@pytest.mark.parametrize("script, plots", [
    ("p3", ["confusion_matrix_test_split.png", "confusion_matrix_train_split.png"]),
    ("p5", ["accuracy_vs_penalty_with_sil.png"]),
])
def test_plots_equal_jax(runs, script, plots):
    folder = runs["tmp"] / script
    assert sorted(os.listdir(folder / "port" / "plots")) == plots
    for name in plots:
        assert (folder / "port" / "plots" / name).read_bytes() == \
            (folder / "jax" / "plots" / name).read_bytes(), name
