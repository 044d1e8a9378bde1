"""``python -m cs304_tpu_torch.scripts.transcribe --device cpu`` against the
JAX package's ``scripts/transcribe.py``, both run in process on the same
tiny checkpoint (tests/test_cli_rich_decode.py's 3-word recipe: 3, 5, 7)
and the same two 3-digit WAVs. The models are trained by the port's library
on the CPU (JAX's own training would cost this file its compilations) and
saved twice, by each package's save_models.

Each option set runs once for each package (a module-scoped fixture):
plain with --csv-out, --confidence --timings, --known-count, --grammar-
strings, --min-duration and --beam. Printed transcripts and word timings
are equal. Confidences are parsed and held in the log domain:
|ln c_port - ln c_jax| <= 4 float32 ulps of the utterance's |log Z| plus
the print's rounding (3 decimals, half a unit on each side). A confidence
is exp(alpha + penalty + beta - log Z) with |log Z| in the thousands, so it
moves in steps of log Z's ulp (2^-8 at these utterances): the emissions of
the two packages round apart by an ulp, as chip_smoke.py phase 22 holds the
card against the CPU (CONF_ULPS = 4). |log Z| is bounded by the Viterbi
best score's magnitude (log Z >= the best path's score, both negative),
taken from the port's decoder. The plain run's CSV files are
byte-equal. Checkpoints cross both ways: every option set decodes the tree
the JAX package saved, except --beam, which decodes the port's, under both
scripts.
"""
import importlib
import importlib.util
import os
import re
import sys

import numpy as np
import pytest

from cs304_tpu_torch.scripts._common import run_in_process
from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("3", "5", "7")
SENTENCES = (("375", 3), ("753", 4))
CONF_ULPS = 4
PORT_SAVED = ("beam",)  # the option sets that decode the tree the port saved
OPTION_SETS = {
    "plain": ["--csv-out", "{tmp}/{pkg}.csv"],
    "confidence_timings": ["--confidence", "--timings"],
    "known_count": ["--known-count", "3"],
    "grammar": ["--grammar-strings", "375,753,555"],
    "min_duration": ["--min-duration", "2"],
    "beam": ["--beam", "50"],
}


def jax_script(name):
    """The JAX script ``name``'s module, loaded by path with scripts/ on
    sys.path (for its ``_common`` import); nothing in scripts/ changes."""
    path = os.path.join(REPO, "scripts", f"{name}.py")
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_script_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.dirname(path))
    return mod


def jax_main(name):
    """A callable running the JAX script ``name`` on an argv list: its
    main() with sys.argv set."""
    mod = jax_script(name)

    def run(argv):
        old = sys.argv
        sys.argv = [name] + list(argv)
        try:
            mod.main()
        finally:
            sys.argv = old
    return run


def port_main(name):
    main = importlib.import_module(f"cs304_tpu_torch.scripts.{name}").main
    return lambda argv: main(list(argv) + ["--device", "cpu"])


def train_tiny(corpus, with_silence=False):
    """The 3-word models of tests/test_cli_rich_decode.py (and a 3-state
    silence model from the clips' endpointed noise), trained by the port on
    the CPU."""
    from cs304_tpu_torch.audio.endpointing import SignalSeparation
    from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig, train_word_hmm
    from cs304_tpu_torch.ops.mfcc import mfcc_batch

    cfg = SegmentalKMeansConfig(num_states=5, max_iterations=4, length_multiple=32)
    models = {label: train_word_hmm(label, mfcc_batch(corpus.train_dataset[label], device="cpu"),
                                    cfg, device="cpu").model
              for label in WORDS}
    if with_silence:
        sep = SignalSeparation()
        for label in WORDS:
            sep.remove_empty_batch(corpus.train_dataset[label])
        noises = [n for n in sep.get_all_noises() if len(n) >= 9 * sep.frame_size]
        # cov_reg 0.01 (the phone boot's): with the default 0.001 the 12
        # short noises give near-singular covariances (alignment scores
        # ~ -5e5) that magnify the front ends' ~1e-5 feature difference
        # to a score difference of 1.2e-5 relative, past rtol 1e-5.
        models["S"] = train_word_hmm("S", mfcc_batch(noises, device="cpu"), SegmentalKMeansConfig(
            num_states=3, max_iterations=4, cov_reg=0.01, length_multiple=32),
            device="cpu").model
    return models


def save_both(models, tmp):
    """The models saved by the JAX package (ckpt_jax) and by the port
    (ckpt_port)."""
    from cs304_tpu.utils.checkpoint import save_models as jax_save
    from cs304_tpu_torch.utils.checkpoint import save_models

    jax_save(models, str(tmp / "ckpt_jax"))
    save_models(models, str(tmp / "ckpt_port"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from cs304_tpu.audio.wav import write_wav_int16
    from cs304_tpu.data.synthetic import SyntheticTIDigits

    tmp = tmp_path_factory.mktemp("cli_transcribe")
    corpus = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1, takes_per_digit=2)
    wavs = []
    for text, seed in SENTENCES:
        wavs.append(str(tmp / f"utt{text}.wav"))
        write_wav_int16(wavs[-1], corpus.sentence_audio(text, 0, jitter_seed=seed), 16000)
    save_both(train_tiny(corpus), tmp)
    mains = {"jax": jax_main("transcribe"), "port": port_main("transcribe")}
    base = ["--wav", wavs[0], "--wav", wavs[1], "--log-file", str(tmp / "runtime.log")]
    out = {}
    for what, opts in OPTION_SETS.items():
        ckpt = str(tmp / ("ckpt_port" if what in PORT_SAVED else "ckpt_jax"))
        for pkg, main in mains.items():
            argv = base + ["--checkpoint-dir", ckpt] + [o.format(tmp=tmp, pkg=pkg) for o in opts]
            out[what, pkg] = run_in_process(main, argv)
    return {"out": out, "tmp": tmp, "wavs": wavs,
            "log_z_ulp": log_z_ulps(str(tmp / "ckpt_jax"), wavs)}


def log_z_ulps(folder, wavs):
    """A float32 ulp of each utterance's |log Z|, at most: the ulp of its
    Viterbi best score's magnitude (the port's decoder on the CPU)."""
    from cs304_tpu_torch.audio.wav import read_wav
    from cs304_tpu_torch.models.decoder import ContinuousDecoder
    from cs304_tpu_torch.ops.mfcc import mfcc_batch
    from cs304_tpu_torch.utils.checkpoint import load_models

    decoder = ContinuousDecoder(load_models(folder), penalty=-100.0, device="cpu")
    ulps = []
    for wav in wavs:
        feats = mfcc_batch([read_wav(wav)[1]], device="cpu")[0]
        best = decoder.predict_nbest(feats, n=1)[0][0]
        ulps.append(float(np.spacing(np.float32(abs(best)))))
    return ulps


def parse(text):
    """transcribe's lines -> [(wav, words, confidence or None, timings)]."""
    rows = []
    for line in text.strip().splitlines():
        m = re.match(r"^(.*\.wav): (\S*)(?:  \[(.*)\])?$", line)
        assert m, line
        extras = (m.group(3) or "").split("  ")
        conf = float(extras[0]) if extras[0] else None
        rows.append((m.group(1), m.group(2), conf, extras[1] if len(extras) > 1 else ""))
    return rows


@pytest.mark.parametrize("what", OPTION_SETS)
def test_transcribe_equals_jax(runs, what):
    got = parse(runs["out"][what, "port"])
    want = parse(runs["out"][what, "jax"])
    assert [r[0] for r in got] == runs["wavs"]
    assert [(r[0], r[1], r[3]) for r in got] == [(r[0], r[1], r[3]) for r in want]
    for g, w, ulp in zip(got, want, runs["log_z_ulp"]):
        assert (g[2] is None) == (w[2] is None)
        if g[2] is not None:
            tol = CONF_ULPS * ulp + 0.0005 / g[2] + 0.0005 / w[2]
            assert abs(np.log(g[2]) - np.log(w[2])) <= tol, (g, w, tol)
    if what in ("plain", "grammar", "known_count"):
        # The tiny models decode these sentences exactly.
        assert [r[1] for r in got] == [s for s, _ in SENTENCES]
    if what == "confidence_timings":
        assert all(r[3].count(";") == 2 and r[2] > 0.5 for r in got)


def test_csv_out_bytes_equal_jax(runs):
    tmp = runs["tmp"]
    assert (tmp / "port.csv").read_bytes() == (tmp / "jax.csv").read_bytes()


def test_checkpoints_cross(runs):
    """Both packages write cs304_tpu.npz.v1 with the same manifest: each
    package's loader reads the other's tree to the same arrays."""
    from cs304_tpu.utils.checkpoint import load_manifest as jax_manifest
    from cs304_tpu.utils.checkpoint import load_models as jax_load
    from cs304_tpu_torch.utils.checkpoint import load_manifest, load_models

    tmp = runs["tmp"]
    for pkg in ("jax", "port"):
        folder = str(tmp / f"ckpt_{pkg}")
        assert load_manifest(folder) == jax_manifest(folder)
        got, want = load_models(folder), jax_load(folder)
        assert sorted(got) == sorted(want) == list(WORDS)
        for label in WORDS:
            for field in ("means", "covariances", "log_a"):
                np.testing.assert_array_equal(getattr(got[label], field),
                                              getattr(want[label], field))


def test_errors_as_jax(runs, capsys):
    """The scripts' own argument errors: the same exit message."""
    tmp, wavs = runs["tmp"], runs["wavs"]
    argv = ["--wav", wavs[0], "--checkpoint-dir", str(tmp / "ckpt_jax"),
            "--known-count", "3", "--beam", "5", "--log-file", str(tmp / "runtime.log")]
    messages = []
    for main in (jax_main("transcribe"), port_main("transcribe")):
        with pytest.raises(SystemExit) as info:
            run_in_process(main, argv)
        messages.append(str(info.value))
    assert messages[0] == messages[1] and "--beam" in messages[1]
