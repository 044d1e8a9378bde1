"""project3_train's GMM options beside the JAX package's script, run in
process on tests/test_torch_cli_train.py's tiny TI-Digits tree (``--device
cpu``): ``--gmm-mixtures 2`` (segmental k-means with K = 2 mixtures) and
``--gmm-mixtures 2 --baum-welch`` (the same, then Baum-Welch refinement on
ops/forward_backward.py), one iteration of each trainer
(``train.max_iterations=1``).

Bound, in units of tests/test_torch_gmm.py's _assert_gmm_model tolerances
(means and weights and log_a rtol 1e-4 / atol 1e-4, covariances rtol 1e-3 /
atol 1e-4), from a measurement of this tree: the k-means models agree to
0.036 (means), 0.075 (covariances), 0 (weights) and 1e-4 (log_a) of them;
one Baum-Welch iteration on those models reaches 6.0, 11.0, 0.43 and 0.45
(and 10.8, 14.4, 0.66, 1.15 after two). The posteriors move with the
emissions' float32 rounding (|log b| up to ~9e4 on padded frames, ~1e3 on
real ones): on digit "1" both packages' new means lie about as far from a
float64 evaluation of the same step (5.3e-4 and 8.6e-4) as from each other
(1.4e-3). So the k-means models are held at 1x, the Baum-Welch means and
covariances at 20x and its weights and log_a at 1x, with -inf in log_a at
the same places; the scripts print the same lines.
"""
import numpy as np
import pytest

from cs304_tpu_torch.scripts._common import run_in_process
from test_torch_bigram_beam import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_cli_train import shared_tree
from test_torch_cli_transcribe import jax_main, port_main

ONE_ITERATION = ["--set", "train.max_iterations=1", "--set", "train.length_multiple=32"]
BOUND = {False: {"means": 1, "covariances": 1, "weights": 1, "log_a": 1},
         True: {"means": 20, "covariances": 20, "weights": 1, "log_a": 1}}
TOL = {"means": (1e-4, 1e-4), "covariances": (1e-3, 1e-4), "weights": (1e-4, 1e-4),
       "log_a": (1e-4, 1e-4)}


@pytest.mark.parametrize("baum_welch", [False, True])
def test_gmm_options_equal_jax(tmp_path_factory, baum_welch):
    from cs304_tpu.utils.checkpoint import load_models as jax_load
    from cs304_tpu_torch.models.gmm_hmm import GMMWordHMM
    from cs304_tpu_torch.utils.checkpoint import load_models

    root = shared_tree(tmp_path_factory)
    tmp = tmp_path_factory.mktemp("cli_gmm")
    extra = ["--gmm-mixtures", "2"] + (["--baum-welch"] if baum_welch else [])
    out = {}
    for pkg, get in (("jax", jax_main), ("port", port_main)):
        out[pkg] = run_in_process(get("project3_train"), [
            "--data-root", root, "--checkpoint-dir", str(tmp / pkg), *ONE_ITERATION,
            "--log-file", str(tmp / "rt.log"), *extra]).replace(str(tmp / pkg), "<out>")
    assert out["port"] == out["jax"]
    assert f"(K=2, bw={baum_welch})" in out["port"]
    got, want = load_models(str(tmp / "port")), jax_load(str(tmp / "jax"))
    assert sorted(got) == sorted(want) and len(got) == 11
    for label, w in want.items():
        g = got[label]
        assert isinstance(g, GMMWordHMM) and g.num_mixtures == 2
        for name, (rtol, atol) in TOL.items():
            a, b = getattr(g, name), getattr(w, name)
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f"{label} {name}")
            k = BOUND[baum_welch][name]
            np.testing.assert_allclose(a[fin], b[fin], rtol=k * rtol, atol=k * atol,
                                       err_msg=f"{label} {name}")
