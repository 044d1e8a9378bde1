"""The port's train_phones (``--device cpu``) against the JAX package's,
run in process at a small size (8 words, 2 tied iterations, 3 training
sentences), and transcribe / align with --lexicon on the phone checkpoint.

- train_phones: every printed line is equal (the out folder aside), the
  lexicon.json bytes are equal, and every saved phone model is within the
  phone tier's parity tolerances (tests/test_torch_phone_tier.py: rtol 1e-4
  / atol 1e-5, -inf at the same places).
- transcribe and align --lexicon: both scripts decode the port's phone
  checkpoint (a tree the JAX package reads too). Printed lines are equal,
  the alignment score within rtol 1e-5 (ForcedAligner's parity tolerance)
  plus the print's rounding, as tests/test_torch_cli_decode.py holds it.
"""
import pytest

from cs304_tpu_torch.scripts._common import run_in_process
from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_cli_decode import same_up_to_tolerance
from test_torch_cli_tools import PACKAGES
from test_torch_lexicon import assert_models_close

TRAIN = ["--num-words", "8", "--iterations", "2", "--train-sentences", "3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from cs304_tpu_torch.audio.wav import write_wav_int16
    from cs304_tpu_torch.data.synthetic import SyntheticTIDigits

    tmp = tmp_path_factory.mktemp("cli_phones")
    log = ["--log-file", str(tmp / "rt.log")]
    corpus = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1, takes_per_digit=2)
    wav = str(tmp / "utt375.wav")
    write_wav_int16(wav, corpus.sentence_audio("375", 1, jitter_seed=9), 16000)
    out = {}
    for pkg, get in PACKAGES:
        out["train_phones", pkg] = run_in_process(get("train_phones"), [
            *TRAIN, "--out-dir", str(tmp / pkg), *log]).replace(str(tmp / pkg), "<out>")
    phones = str(tmp / "port")
    lex = ["--checkpoint-dir", phones, "--lexicon", f"{phones}/lexicon.json", "--wav", wav]
    for pkg, get in PACKAGES:
        out["transcribe", pkg] = run_in_process(get("transcribe"), lex + log)
        out["align", pkg] = run_in_process(get("align"), lex + ["--transcript", "bab,bad"] + log)
    return {"tmp": tmp, "out": out}


def test_train_phones_equals_jax(runs):
    from cs304_tpu.utils.checkpoint import load_models as jax_load
    from cs304_tpu_torch.utils.checkpoint import load_models

    tmp, out = runs["tmp"], runs["out"]
    assert out["train_phones", "port"] == out["train_phones", "jax"]
    lines = out["train_phones", "port"].strip().splitlines()
    assert lines[-1] == "saved 21 phone models + lexicon.json to <out>"
    assert (tmp / "port" / "lexicon.json").read_bytes() == \
        (tmp / "jax" / "lexicon.json").read_bytes()
    got, want = load_models(str(tmp / "port")), jax_load(str(tmp / "jax"))
    assert len(got) == 21
    assert_models_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("script", ["transcribe", "align"])
def test_lexicon_decoding_equals_jax(runs, script):
    got, want = runs["out"][script, "port"], runs["out"][script, "jax"]
    same_up_to_tolerance(got, want, prob_tol=0.0)
    if script == "transcribe":
        assert got.startswith("composed 8 words from ")
    else:
        assert "transcript=bab,bad" in got.splitlines()[0]
