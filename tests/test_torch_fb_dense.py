"""FBD, the dense forward-backward (ops/cuda/forward_backward.py), on the
CPU: its plain version's three modes through ops/forward_backward.py
against cs304_tpu.ops.forward_backward on the same seeded numpy inputs.

Cases: S = 1, 2 and 5 (uniform_forward_log_a, which fills the upper
triangle, and its banded matrix), the legacy trainer's sentence matrix
(banded_transition_matrix of _sentence_log_a, S_sent = 27 for "S3S2S1S"),
each with and without log_final; padded rows, a length-1 row, T = 1, an
all -inf column of log_a (-inf, never NaN) and a pinned final no path
reaches (ll = -inf: the same NaN and +inf cells as JAX's gamma and xi).

Tolerances: the same -inf, +inf and NaN cells; finite values within rtol
1e-5 / atol 1e-5 (tests/test_torch_forward_backward.py's: float32 sums in
another order than XLA's). The plain version's sums are ascending adds from
+0: held bitwise to a scalar loop of the same adds.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.ops import forward_backward as jfb
from cs304_tpu_torch.models.hmm import uniform_forward_log_a
from cs304_tpu_torch.models.train_continuous import (
    ContinuousTrainConfig,
    ContinuousTrainer,
    _topology,
    insert_silence,
)
from cs304_tpu_torch.ops import forward_backward as tfb
from cs304_tpu_torch.ops.cuda import forward_backward as fbd
from cs304_tpu_torch.ops.viterbi import banded_transition_matrix
from test_torch_train_fused import make_models
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _close(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    for cells in (np.isfinite, np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(cells(got), cells(want), err_msg=f"{what} {cells}")
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5, err_msg=what)


def _sentence_matrix():
    """The (S_sent, S_sent) matrix _stats_pass_bw hands forward_backward."""
    models = make_models(seed=0)
    tr = ContinuousTrainer(models, ContinuousTrainConfig(fused=False), device="cpu")
    topo = _topology(insert_silence("321"), tr.state_counts, tr.label_index)
    log_a_sent = tr._sentence_args(topo)[2]
    return banded_transition_matrix(torch.as_tensor(log_a_sent)).numpy()


def _matrix(kind, s):
    if kind == "sentence":
        return _sentence_matrix()
    log_a = uniform_forward_log_a(s)
    if kind == "banded":
        log_a = banded_transition_matrix(torch.as_tensor(log_a)).numpy()
    if kind == "dead-column":
        log_a[:, min(2, s - 1)] = -np.inf
    return np.ascontiguousarray(log_a, np.float32)


CASES = {  # name -> (matrix kind, S, T, lengths)
    "S1": ("uniform", 1, 6, [6, 3, 1]),
    "S2": ("uniform", 2, 7, [7, 1, 4]),
    "S5-uniform": ("uniform", 5, 12, [12, 7, 1, 9]),
    "S5-banded": ("banded", 5, 12, [12, 2, 1, 9]),  # length 2 cannot reach state 4
    "S5-T1": ("banded", 5, 1, [1, 1]),
    "S5-dead-column": ("dead-column", 5, 10, [10, 6]),
    "sentence": ("sentence", 27, 40, [40, 28, 9, 1]),
}


def _case(name, seed):
    kind, s, t, lengths = CASES[name]
    log_a = _matrix(kind, s)
    s = log_a.shape[0]
    rng = np.random.default_rng(seed)
    log_b = (rng.normal(size=(len(lengths), t, s)) * 3).astype(np.float32)
    log_b[:, :, -1] += 2.0
    log_init = np.full(s, -np.inf, np.float32)
    log_init[0] = 0.0
    log_final = np.full(s, -np.inf, np.float32)
    log_final[-1] = 0.0
    return log_b, log_a, log_init, np.asarray(lengths, np.int32), log_final


@pytest.mark.parametrize("pin_final", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_modes_match_jax(name, pin_final):
    log_b, log_a, log_init, lengths, log_final = _case(name, len(name))
    fin_t = torch.from_numpy(log_final) if pin_final else None
    fin_j = jnp.asarray(log_final) if pin_final else None
    args_t = [torch.from_numpy(x) for x in (log_b, log_a, log_init)]
    lens_t = torch.from_numpy(lengths)
    alpha, ll = tfb.forward(*args_t, lens_t, fin_t)
    beta = tfb.backward(args_t[0], args_t[1], lens_t, fin_t)
    gamma, xi, ll_p = tfb.forward_backward(*args_t, lens_t, fin_t)
    torch.testing.assert_close(ll_p, ll, rtol=0, atol=0, equal_nan=True)
    neg_ll = 0
    for i, n in enumerate(lengths):
        lb = jnp.asarray(log_b[i])
        w_alpha, w_ll = jfb.forward(lb, jnp.asarray(log_a), jnp.asarray(log_init), int(n), fin_j)
        _close(alpha[i], w_alpha, f"alpha {name} {i}")
        _close(ll[i], w_ll, f"ll {name} {i}")
        _close(beta[i], jfb.backward(lb, jnp.asarray(log_a), int(n), fin_j), f"beta {name} {i}")
        want = jfb.forward_backward(lb, jnp.asarray(log_a), jnp.asarray(log_init), int(n),
                                    fin_j)
        for w, g, what in zip(want, (gamma[i], xi[i], ll_p[i]), ("gamma", "xi", "ll")):
            _close(g, w, f"{what} {name} {i}")
        neg_ll += int(not np.isfinite(float(w_ll)))
        if not pin_final:
            _close(tfb.forward_log_likelihood(torch.from_numpy(log_b[i]), *args_t[1:], int(n)),
                   jfb.forward_log_likelihood(lb, jnp.asarray(log_a), jnp.asarray(log_init),
                                              int(n)), f"loglik {name} {i}")
    # A pinned final that a row cannot reach (length 1 at S > 1; length 2
    # on the banded matrix): ll = -inf, and the posteriors are JAX's NaN
    # (no substitution).
    if name == "S5-banded" and pin_final:
        assert not np.isfinite(float(ll[1])) and bool(torch.isnan(gamma[1, :2]).all())
    if not pin_final:
        assert neg_ll == 0
    if name == "S5-dead-column":
        assert not bool(torch.isnan(alpha).any()) and bool(torch.isneginf(alpha[0, 1:, 2]).all())


def test_lse_ascending_is_a_sum_in_ascending_order():
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(3, 9, 4)) * 30).astype(np.float32))
    x[0, :, 1] = float("-inf")
    x[1, 2:5, 2] = float("-inf")
    got = fbd.lse_ascending(x, 1)
    for b in range(3):
        for j in range(4):
            col = x[b, :, j]
            m = col.max()
            if not torch.isfinite(m):
                assert torch.isneginf(got[b, j])
                continue
            s = torch.zeros(())
            for i in range(9):
                s = s + torch.exp(col[i] - m)
            assert got[b, j].view(torch.int32) == (torch.log(s) + m).view(torch.int32)


def test_ops_dispatch_cpu_tensors_to_the_plain_version(monkeypatch):
    """Each op is one call of fb_dense, which sends a CPU tensor to its
    plain version (no kernel launch), in the op's mode."""
    log_b, log_a, log_init, lengths, log_final = _case("S5-uniform", 1)
    modes = []
    plain = fbd.fb_dense_plain

    def spy(*args):
        modes.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(fbd, "fb_dense_plain", spy)
    args = [torch.from_numpy(x) for x in (log_b, log_a, log_init)]
    tfb.forward(*args, torch.from_numpy(lengths))
    tfb.backward(args[0], args[1], torch.from_numpy(lengths), torch.from_numpy(log_final))
    tfb.forward_backward(args[0][0], *args[1:], 5)
    tfb.forward_log_likelihood(args[0][0], *args[1:])
    assert modes == ["forward", "backward", "posteriors", "forward"]
    assert fbd.fb_dense.launches == 0
    with pytest.raises(ValueError, match="mode"):
        fbd.fb_dense(*args, torch.from_numpy(lengths), None, "viterbi")
