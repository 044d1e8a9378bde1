"""The port's project5_test_ndigits (``--device cpu``) against the JAX
package's, run in process on the TI-Digits tree and the checkpoint of
tests/test_torch_cli_tools.py (each script reads its own package's save),
at 2 digits.

- Beside the JAX script: the plain decode with --csv-out, and --bigram-lm
  with --beam (the script's LM building, the LM weight and the beam in one
  decode). Every printed line (accuracy, WER and its counts, the LM's
  summary) is equal, the CSV files byte for byte, and the plain decode's
  CSVs reach the chain test's bar (>= 0.9, tests/test_cli_chain.py). The
  scripts refuse a combination with the same message.
- --known-count and --min-duration: the predictions in the port script's
  CSVs equal the port's ContinuousDecoder.predict_batch_counted /
  predict_batch_duration on the same features. Those library calls are
  held against JAX's in tests/test_torch_constrained.py, and the
  transcribe script's options against JAX's script in
  tests/test_torch_cli_transcribe.py; a JAX twin here would add only its
  compilations.
"""
import re

import pytest

from cs304_tpu_torch.reporting.csvnia import CSVReader
from cs304_tpu_torch.scripts._common import run_in_process
from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_cli_tools import PACKAGES, shared_checkpoint
from test_torch_cli_transcribe import port_main

TWINS = {
    "plain": ["--csv-out", "{tmp}/{pkg}_ndigits"],
    "bigram_lm_beam": ["--bigram-lm", "--lm-weight", "0.5", "--beam", "50"],
}
PORT_ONLY = {
    "known_count": ["--known-count"],
    "min_duration": ["--min-duration", "2"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = shared_checkpoint(tmp_path_factory)
    tmp = tmp_path_factory.mktemp("cli_ndigits")
    base = ["--data-root", ck["root"], "--n-digits", "2", *ck["log"]]
    out = {(what, pkg): run_in_process(get("project5_test_ndigits"), base + [
        "--checkpoint-dir", ck[pkg], *(o.format(tmp=tmp, pkg=pkg) for o in opts)])
        for what, opts in TWINS.items() for pkg, get in PACKAGES}
    for what, opts in PORT_ONLY.items():
        out[what] = run_in_process(port_main("project5_test_ndigits"), base + [
            "--checkpoint-dir", ck["port"], *opts, "--csv-out", str(tmp / what)])
    return {"tmp": tmp, "out": out, "base": base, "ck": ck}


@pytest.mark.parametrize("what", TWINS)
def test_ndigits_equals_jax(runs, what):
    got = runs["out"][what, "port"]
    assert got == runs["out"][what, "jax"]
    lines = got.strip().splitlines()
    if what == "bigram_lm_beam":
        assert lines.pop(0).startswith("bigram LM: 23 training transcripts, vocab [")
    for split, (acc, wer) in zip(("train", "test"), zip(lines[::2], lines[1::2])):
        assert acc.startswith(f"{split} exact-sequence accuracy (n=2): ")
        assert re.fullmatch(rf"{split} WER: [\d.]+% \(sub \d+, ins \d+, del \d+ / \d+ words\)",
                            wer)


def test_csv_bytes_equal_jax(runs):
    tmp = runs["tmp"]
    for split in ("train", "test"):
        path = tmp / f"port_ndigits.{split}.csv"
        assert path.read_bytes() == (tmp / f"jax_ndigits.{split}.csv").read_bytes()
        rows = list(CSVReader(str(path)))
        acc = sum(r["Ground Truth"] == r["Predict"] for r in rows) / len(rows)
        assert rows and acc >= 0.9, (split, acc)


@pytest.mark.parametrize("what", PORT_ONLY)
def test_constrained_decodes_equal_library(runs, what):
    from cs304_tpu_torch.data.ti_digits import TIDigits
    from cs304_tpu_torch.models.decoder import ContinuousDecoder
    from cs304_tpu_torch.ops.mfcc import mfcc_batch
    from cs304_tpu_torch.utils.checkpoint import load_models
    from cs304_tpu_torch.utils.config import Config

    corpus = TIDigits(runs["ck"]["root"])
    decoder = ContinuousDecoder(load_models(runs["ck"]["port"]),
                                penalty=Config().decode.word_penalty, device="cpu")
    for split, dataset in (("train", corpus.train_dataset), ("test", corpus.test_dataset)):
        grouped = dataset.get_all_n_digits(2)
        truths = [t for t, utts in grouped.items() for _u in utts]
        feats = mfcc_batch([u for utts in grouped.values() for u in utts], device="cpu")
        if what == "known_count":
            want = decoder.predict_batch_counted(feats, 2)
        else:
            want = decoder.predict_batch_duration(feats, min_duration=2)
        rows = list(CSVReader(str(runs["tmp"] / f"{what}.{split}.csv")))
        assert [r["Ground Truth"] for r in rows] == truths
        assert [r["Predict"] for r in rows] == want
        assert f"{split} exact-sequence accuracy (n=2): " in runs["out"][what]


def test_refused_combination_as_jax(runs):
    messages = []
    for pkg, get in PACKAGES:
        with pytest.raises(SystemExit) as info:
            run_in_process(get("project5_test_ndigits"), runs["base"] + [
                "--checkpoint-dir", runs["ck"][pkg], "--min-duration", "2", "--bigram-lm"])
        messages.append(str(info.value))
    assert messages[0] == messages[1] and "--min-duration" in messages[1]
