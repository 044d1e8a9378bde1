"""The port's typed config, reporting tools and profiling hooks against the
JAX package's (cs304_tpu/utils, cs304_tpu/reporting).

Config: equal to_dict() for the defaults, after overrides and from a JSON
file; the same KeyError / TypeError / ValueError on bad overrides;
mfcc_config() the port's MFCCConfig with the JAX one's fields. CSVWriter:
byte-equal files, and each package's reader parses the other's file.
alignment_debug: equal strings and counts. confusion_matrix: equal arrays.
The spectrograms: the NumPy arrays bitwise, the MFCC heatmap within the
front ends' atol 1e-4 (tests/test_torch_mfcc.py); the plot files written
(matplotlib is present here). phase_timer / device_trace on the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

from cs304_tpu.reporting import csvnia as jcsv
from cs304_tpu.reporting import spectrograms as jspec
from cs304_tpu.reporting import visualizer as jvis
from cs304_tpu.utils import alignment_debug as jdbg
from cs304_tpu.utils.config import Config as JConfig
from cs304_tpu_torch.ops.mfcc import MFCCConfig
from cs304_tpu_torch.reporting import csvnia as tcsv
from cs304_tpu_torch.reporting import spectrograms as tspec
from cs304_tpu_torch.reporting import visualizer as tvis
from cs304_tpu_torch.utils import alignment_debug as tdbg
from cs304_tpu_torch.utils import profiling
from cs304_tpu_torch.utils.config import Config as TConfig

OVERRIDES = [
    ["decode.word_penalty=-250", "train.num_states=7"],
    ["frontend.normalization=cmvn", "continuous.update=baum_welch",
     "train.cov_reg=1", "labels=[\"1\", \"2\"]"],
    ["continuous.silence_bootstrap=false", "endpoint.frame_time=0.02",
     "data_root=/data/tidigits"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=["penalty", "mixed", "bools"])
def test_config_against_jax(overrides, tmp_path):
    assert TConfig().to_dict() == JConfig().to_dict()
    got, want = TConfig(), JConfig()
    got.apply_overrides(overrides)
    want.apply_overrides(overrides)
    assert got.to_dict() == want.to_dict()
    path = str(tmp_path / "cfg.json")
    want.save(path)
    assert TConfig.from_file(path).to_dict() == want.to_dict()
    got.save(str(tmp_path / "mine.json"))
    with open(path) as a, open(tmp_path / "mine.json") as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("bad, error", [
    ("decode.bogus=1", KeyError), ("nosection.x=1", KeyError),
    ("train.num_states=hello", TypeError), ("no_equals_sign", ValueError),
])
def test_config_errors_as_jax(bad, error):
    messages = []
    for cfg in (JConfig(), TConfig()):
        with pytest.raises(error) as info:
            cfg.apply_overrides([bad])
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_mfcc_config_is_the_ports():
    for norm in ("per_frame", "cmvn"):
        t, j = TConfig(), JConfig()
        t.apply_overrides([f"frontend.normalization={norm}"])
        j.apply_overrides([f"frontend.normalization={norm}"])
        got, want = t.frontend.mfcc_config(), j.frontend.mfcc_config()
        assert isinstance(got, MFCCConfig)
        for name in ("sample_rate", "n_fft", "hop_length", "n_mels", "n_mfcc", "fmin",
                     "fmax", "normalization", "amin", "top_db", "delta_width"):
            assert getattr(got, name) == getattr(want, name), name


def test_csv_bytes_equal_jax(tmp_path):
    rows = [["4Z2Z1", "4Z2Z", 7], ['has"quote', None, 0], ["", "a|b", 12]]
    for mod, name in ((jcsv, "jax.csv"), (tcsv, "port.csv")):
        w = mod.CSVWriter(["Ground Truth", "Predict", "Count"])
        for r in rows:
            w.add_line(r)
        w.write(str(tmp_path / name))
    assert (tmp_path / "jax.csv").read_bytes() == (tmp_path / "port.csv").read_bytes()
    for mod in (jcsv, tcsv):
        assert list(mod.CSVReader(str(tmp_path / "jax.csv"))) == \
            list(jcsv.CSVReader(str(tmp_path / "port.csv")))
    with pytest.raises(ValueError):
        tcsv.CSVWriter(["a", "b"]).add_line([1])


def test_alignment_debug_equal_jax():
    rng = np.random.default_rng(3)
    paths = [np.sort(rng.integers(0, 5, size=n)) for n in (1, 17, 40)] + [[]]
    for p in paths:
        assert tdbg.run_length(p) == jdbg.run_length(p)
        assert tdbg.path_string(p) == jdbg.path_string(p)
    full = paths[:3]
    np.testing.assert_array_equal(tdbg.state_counts(full, 6), jdbg.state_counts(full, 6))
    assert tdbg.count_table(full, 6) == jdbg.count_table(full, 6)
    assert tdbg.histogram(full, 6, width=30) == jdbg.histogram(full, 6, width=30)


def test_confusion_matrix_and_plots(tmp_path):
    pytest.importorskip("matplotlib")
    names = ["1", "2", "Z"]
    truth = ["1", "1", "2", "Z", "Z", "1"]
    pred = ["1", "2", "2", "Z", "1", "1"]
    cm = tvis.confusion_matrix(pred, truth, names)
    np.testing.assert_array_equal(cm, jvis.confusion_matrix(pred, truth, names))
    p = tvis.plot_confusion_matrix_from_lists(pred, truth, names, title="t",
                                              out_dir=str(tmp_path))
    q = tvis.plot_line([0, -50, -100], [0.5, 0.9, 0.8], title="acc vs pen",
                       out_dir=str(tmp_path))
    assert p.endswith("confusion_matrix_t.png") and q.endswith("acc_vs_pen.png")
    assert os.path.getsize(p) > 0 and os.path.getsize(q) > 0
    with pytest.raises(ValueError):
        tvis.plot_line([1, 2], [1], out_dir=str(tmp_path))


def test_spectrograms_against_jax(tmp_path):
    rng = np.random.default_rng(0)
    sig = (np.sin(np.arange(4000) * 0.2) * 3000 + rng.normal(0, 50, 4000)).astype(np.float32)
    for name in ("power_spectrogram_db", "mel_spectrogram_db", "cepstrum"):
        np.testing.assert_array_equal(getattr(tspec, name)(sig), getattr(jspec, name)(sig))
    got = tspec.mfcc_heatmap_data(sig, device="cpu")
    want = jspec.mfcc_heatmap_data(sig)
    assert got.shape == want.shape == (1 + 4000 // 160, 39)
    np.testing.assert_allclose(got, want, atol=1e-4)
    pytest.importorskip("matplotlib")
    paths = [tspec.plot_spectrogram(sig, out_dir=str(tmp_path)),
             tspec.plot_mel_spectrogram(sig, out_dir=str(tmp_path)),
             tspec.plot_mfcc(sig, out_dir=str(tmp_path), device="cpu")]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_phase_timer_and_device_trace(tmp_path):
    profiling.reset_timings()
    with profiling.phase_timer("unit_phase", sync=[torch.ones(3), {"x": torch.zeros(1)}]):
        sum(range(1000))
    with profiling.phase_timer("unit_phase"):
        pass
    t = profiling.timings()
    assert set(t) == {"unit_phase"} and t["unit_phase"] >= 0
    profiling.reset_timings()
    assert profiling.timings() == {}
    with profiling.device_trace(str(tmp_path / "trace")) as log_dir:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_progress_and_logging(tmp_path):
    import logging

    from cs304_tpu_torch.utils.logging import setup_logging
    from cs304_tpu_torch.utils.progress import progress_bar

    with progress_bar(10, "x", enabled=False) as bar:
        bar.update()
    root = logging.getLogger()
    kept = list(root.handlers)
    try:
        setup_logging(str(tmp_path / "run.log"), console=False)
        logging.getLogger("cli").info("hello")
        for h in root.handlers:
            h.flush()
        assert "hello" in (tmp_path / "run.log").read_text()
    finally:
        for h in root.handlers[:]:
            if h not in kept:
                root.removeHandler(h)
                h.close()
        for h in kept:
            if h not in root.handlers:
                root.addHandler(h)
