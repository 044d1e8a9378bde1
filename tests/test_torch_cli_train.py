"""The port's training scripts (``--device cpu``) against the JAX package's,
run in process on a tiny TI-Digits tree written by the test (the layout of
tests/test_tidigits_tree.py: 2 training speakers and 1 test speaker, takes
"a" and "b", PCM16 WAVs of the synthetic corpus with its sentences).

- project3_train and project5_train_no_empty: each package trains from the
  tree; every model's parameters agree within the trainers' parity
  tolerances (tests/test_torch_train_kmeans.py): means rtol 1e-5 /
  atol 1e-5, covariances rtol 1e-4 / atol 1e-5, log_a atol 1e-6 with -inf
  at the same places.
- project6_train: both packages boot from the JAX package's project5
  checkpoint (the same inputs, as tests/test_torch_train_continuous.py
  feeds both trainers one boot), with --state-dir; the same tolerances.
  (Booting each from its own project5 checkpoint is not the same input: a
  7.6e-6 difference in a boot mean can move a segment boundary of the
  embedded training on this 2-speaker corpus.)
- --data-parallel trains on a 1-rank mesh (tests/test_torch_parallel*.py
  hold the mesh against JAX's), and its checkpoint is bitwise the run
  without the flag; --resume on the state folder that the JAX package's
  project6_train wrote (Orbax) exits 1 with "no trainer state at ...", and
  never trains from another state.
"""
import os

import numpy as np
import pytest

from cs304_tpu_torch.scripts._common import run_in_process
from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_cli_transcribe import jax_main, port_main

TAKES = "ab"
KMEANS = ["--set", "train.max_iterations=6", "--set", "train.length_multiple=32"]
EMBEDDED = ["--set", "continuous.max_iterations=3", "--set", "continuous.cov_reg=0.1"]


def write_tree(root):
    """tests/test_tidigits_tree.py's layout under ``root``."""
    from cs304_tpu.audio.wav import write_wav_int16
    from cs304_tpu.data.synthetic import SyntheticTIDigits

    corpus = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1,
                               takes_per_digit=len(TAKES), with_sentences=True)
    splits = {"TRAIN": (corpus.train_dataset, ["AH", "BC"]), "TEST": (corpus.test_dataset, ["CK"])}
    for split, (loader, speakers) in splits.items():
        for label, clips in loader.data.items():
            per_spk = max(1, len(clips) // len(speakers))
            for i, clip in enumerate(clips):
                spk = speakers[min(i // per_spk, len(speakers) - 1)]
                d = os.path.join(root, "Adults", "TIDIGITS", split, "MAN", spk)
                os.makedirs(d, exist_ok=True)
                path = os.path.join(d, f"{label}{TAKES[i % len(TAKES)]}.wav")
                if not os.path.exists(path):
                    write_wav_int16(path, clip, 16000)


_TREES = {}


def shared_tree(tmp_path_factory):
    """write_tree's tree, written once in a process: the files that use it
    share it when they run in one."""
    if not _TREES:
        _TREES["root"] = str(tmp_path_factory.mktemp("cli_tree") / "ConvertedTIDigits")
        write_tree(_TREES["root"])
    return _TREES["root"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_train")
    root = shared_tree(tmp_path_factory)
    log = ["--log-file", str(tmp / "rt.log")]
    out = {}
    for pkg, get in (("jax", jax_main), ("port", port_main)):
        d = str(tmp / pkg)
        out["project3_train", pkg] = run_in_process(get("project3_train"), [
            "--data-root", root, "--checkpoint-dir", f"{d}/ck3", *KMEANS, *log])
        out["project5_train_no_empty", pkg] = run_in_process(get("project5_train_no_empty"), [
            "--data-root", root, "--checkpoint-dir", f"{d}/ck5", *KMEANS, *log])
        out["project6_train", pkg] = run_in_process(get("project6_train"), [
            "--data-root", root, "--checkpoint-dir", str(tmp / "jax" / "ck5"),
            "--out-dir", f"{d}/ck6", "--state-dir", f"{d}/state", *EMBEDDED, *log])
    return {"tmp": tmp, "root": root, "out": out, "log": log}


def same_models(port_dir, jax_dir):
    from cs304_tpu.utils.checkpoint import load_models as jax_load
    from cs304_tpu_torch.utils.checkpoint import load_models

    got, want = load_models(port_dir), jax_load(jax_dir)
    assert sorted(got) == sorted(want)
    for label, w in want.items():
        g = got[label]
        np.testing.assert_allclose(g.means, w.means, rtol=1e-5, atol=1e-5, err_msg=label)
        np.testing.assert_allclose(g.covariances, w.covariances, rtol=1e-4, atol=1e-5,
                                   err_msg=label)
        fin = np.isfinite(w.log_a)
        np.testing.assert_array_equal(np.isfinite(g.log_a), fin, err_msg=label)
        np.testing.assert_allclose(g.log_a[fin], w.log_a[fin], rtol=0, atol=1e-6, err_msg=label)
    return sorted(got)


@pytest.mark.parametrize("script, folder, labels", [
    ("project3_train", "ck3", 11),
    ("project5_train_no_empty", "ck5", 12),
    ("project6_train", "ck6", 12),
])
def test_training_equals_jax(trained, script, folder, labels):
    tmp = trained["tmp"]
    labels_got = same_models(str(tmp / "port" / folder), str(tmp / "jax" / folder))
    assert len(labels_got) == labels
    got, want = (trained["out"][script, pkg].replace(str(tmp / pkg), "<out>")
                 for pkg in ("port", "jax"))
    assert got == want


def test_state_dir_is_the_ports_npz(trained):
    """The port's --state-dir holds trainer_state.npz (ROADMAP item 22);
    the JAX package's holds Orbax state."""
    tmp = trained["tmp"]
    assert os.listdir(tmp / "port" / "state") == ["trainer_state.npz"]
    assert "trainer_state.npz" not in os.listdir(tmp / "jax" / "state")


def _run_main(argv, tmp, capsys):
    """The port's project6_train through run_main, as the command line runs
    it: (exit code, stdout, stderr)."""
    from cs304_tpu_torch.scripts import project6_train
    from cs304_tpu_torch.scripts._common import run_main

    capsys.readouterr()
    argv = [*argv, "--device", "cpu", "--log-file", str(tmp / "rt_cli.log")]
    with pytest.raises(SystemExit) as info:
        run_in_process(lambda _: run_main(lambda: project6_train.main(argv)), None)
    out, err = capsys.readouterr()
    return info.value.code, out, err


def test_data_parallel_and_orbax_resume_exit_1(trained, capsys, monkeypatch):
    """--data-parallel trains (a 1-rank mesh, bitwise the run without the
    flag); --resume on Orbax state exits 1."""
    from cs304_tpu_torch.utils.checkpoint import load_models

    monkeypatch.delenv("CS304_TRACEBACK", raising=False)
    tmp, root = trained["tmp"], trained["root"]
    base = ["--data-root", root, "--checkpoint-dir", str(tmp / "jax" / "ck5"),
            "--out-dir", str(tmp / "never"), *EMBEDDED]
    dp = ["--data-root", root, "--checkpoint-dir", str(tmp / "jax" / "ck5"),
          "--out-dir", str(tmp / "dp" / "ck6"), "--state-dir", str(tmp / "dp" / "state"),
          *EMBEDDED, *trained["log"], "--data-parallel"]
    out = run_in_process(port_main("project6_train"), dp)
    lines = out.replace(str(tmp / "dp"), "<out>").splitlines()
    assert lines.pop(1) == "data-parallel mesh over 1 device(s)"
    want = trained["out"]["project6_train", "port"].replace(str(tmp / "port"), "<out>")
    assert lines == want.splitlines()
    got, single = load_models(str(tmp / "dp" / "ck6")), load_models(str(tmp / "port" / "ck6"))
    assert sorted(got) == sorted(single)
    for label, m in single.items():
        for name in ("means", "covariances", "log_a"):
            assert np.array_equal(getattr(got[label], name), getattr(m, name)), (label, name)
    assert os.listdir(tmp / "dp" / "state") == ["trainer_state.npz"]
    rc, out, err = _run_main(base + ["--state-dir", str(tmp / "jax" / "state"), "--resume"],
                             tmp, capsys)
    assert rc == 1
    assert err.strip().splitlines()[-1] == (
        f"error: no trainer state at {str(tmp / 'jax' / 'state' / 'trainer_state.npz')!r}")
    assert not os.path.exists(tmp / "never")
