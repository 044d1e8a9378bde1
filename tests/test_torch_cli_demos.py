"""The port's streaming and serving demos (``--device cpu``) against the JAX
package's, run in process on the checkpoint of tests/test_torch_cli_tools.py
(the port's embedded training on the TI-Digits tree, saved by each
package): demo_streaming on a 3-digit WAV, demo_streaming_batch and
demo_serving on their built-in utterances.

Every printed line is equal: partials, finals, scores, plans. On top, the
streamed finals equal the offline decodes the demos print, and every
serving utterance is finalized.
"""
import re

import pytest

from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_cli_tools import run_twins, shared_checkpoint


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from cs304_tpu_torch.audio.wav import write_wav_int16
    from cs304_tpu_torch.data.synthetic import SyntheticTIDigits

    ck = shared_checkpoint(tmp_path_factory)
    tmp = tmp_path_factory.mktemp("cli_demos")
    corpus = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1, takes_per_digit=2)
    wav = str(tmp / "utt375.wav")
    write_wav_int16(wav, corpus.sentence_audio("375", 1, jitter_seed=9), 16000)
    base = ["--checkpoint-dir", "{ck}"]
    return {
        "demo_streaming": run_twins("demo_streaming", base + ["--wav", wav], ck),
        "demo_streaming_batch": run_twins("demo_streaming_batch", base, ck),
        "demo_serving": run_twins("demo_serving", base, ck),
    }


@pytest.mark.parametrize("what", ["demo_streaming", "demo_streaming_batch", "demo_serving"])
def test_demo_equals_jax(runs, what):
    assert runs[what]["port"] == runs[what]["jax"]


def test_streaming_and_serving_demos(runs):
    out = {k: v["port"] for k, v in runs.items()}
    final = re.search(r"streaming final:  '(\w*)'", out["demo_streaming"]).group(1)
    assert final == "375" and "offline decode:   '375'" in out["demo_streaming"]
    pairs = re.findall(r"streamed '(\w*)' \(score [-\d.]+\); offline '(\w*)'",
                       out["demo_streaming_batch"])
    assert len(pairs) == 3 and all(s == o for s, o in pairs)
    finals = re.findall(r"mic (\d): FINAL '(\w*)'", out["demo_serving"])
    assert sorted(m for m, _t in finals) == ["0", "0", "1", "2", "2"], finals
