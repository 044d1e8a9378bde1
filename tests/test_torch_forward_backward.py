"""ops/logmath.py and ops/forward_backward.py of the port against the JAX
package's, on the same numpy inputs from a seed (S = 5 left-to-right word
models, padded sequences, with and without log_final).

Tolerances: -inf in exactly the same places; finite values within
rtol 1e-5 (atol 1e-5 for values near 0, such as posteriors); argmaxes and
safe_log's zeros exactly equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.ops import forward_backward as jfb
from cs304_tpu.ops import logmath as jlm
from cs304_tpu_torch.models.hmm import uniform_forward_log_a
from cs304_tpu_torch.ops import forward_backward as tfb
from cs304_tpu_torch.ops import logmath as tlm


def _close(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5, err_msg=what)


def test_logmath_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 7)).astype(np.float32) * 20
    x[rng.random((6, 7)) < 0.3] = -np.inf
    x[2] = -np.inf  # an all -inf slice
    x[:, 3] = -np.inf
    for axis in (0, 1, -1, None):
        for keep in (False, True):
            want = jlm.logsumexp(jnp.asarray(x), axis=axis, keepdims=keep)
            got = tlm.logsumexp(torch.from_numpy(x), axis=axis, keepdims=keep)
            if axis is None and keep:
                want = np.asarray(want).reshape(-1)
                got = got.reshape(-1)
            _close(got, want, f"logsumexp axis={axis} keepdims={keep}")
    alpha = rng.normal(size=7).astype(np.float32)
    alpha[1] = -np.inf
    log_m = x[:, :].T[:7, :6].copy()
    log_m = np.concatenate([log_m, log_m[:, :1]], axis=1)  # (7, 7)
    log_m[0, 2] = log_m[1, 2] = 5.0  # a tie: the first index wins
    alpha[0] = alpha[1] = 0.0
    w_v, w_i = jlm.max_plus_vecmat(jnp.asarray(alpha), jnp.asarray(log_m))
    g_v, g_i = tlm.max_plus_vecmat(torch.from_numpy(alpha), torch.from_numpy(log_m))
    _close(g_v, w_v, "max_plus values")
    np.testing.assert_array_equal(g_i.numpy(), np.asarray(w_i))
    assert g_i.dtype == torch.int32
    _close(tlm.log_plus_vecmat(torch.from_numpy(alpha), torch.from_numpy(log_m)),
           jlm.log_plus_vecmat(jnp.asarray(alpha), jnp.asarray(log_m)), "log_plus_vecmat")
    p = np.array([0.0, -0.0, 1e-30, 0.5, 1.0, 2e-45], np.float32)
    _close(tlm.safe_log(torch.from_numpy(p)), jlm.safe_log(jnp.asarray(p)), "safe_log")
    assert tlm.NEG_INF == jlm.NEG_INF


def _sequences(seed, b=4, t=12, s=5):
    rng = np.random.default_rng(seed)
    log_b = (rng.normal(size=(b, t, s)) * 3).astype(np.float32)
    log_a = uniform_forward_log_a(s)
    log_a[1, 3] = -np.inf  # a forbidden skip
    log_init = np.full(s, -np.inf, np.float32)
    log_init[0] = 0.0
    lengths = np.array([t, 7, 1, 9][:b], np.int32)
    log_final = np.full(s, -np.inf, np.float32)
    log_final[-1] = 0.0
    return log_b, log_a, log_init, lengths, log_final


@pytest.mark.parametrize("pin_final", [False, True])
def test_forward_backward_matches_jax(pin_final):
    log_b, log_a, log_init, lengths, log_final = _sequences(1)
    fin = log_final if pin_final else None
    t_fin = torch.from_numpy(log_final) if pin_final else None
    j_fin = jnp.asarray(log_final) if pin_final else None
    t_args = [torch.from_numpy(x) for x in (log_a, log_init)]
    batched = tfb.forward_backward(torch.from_numpy(log_b), *t_args,
                                   torch.from_numpy(lengths), t_fin)
    for i, n in enumerate(lengths):
        lb = log_b[i]
        w_alpha, w_ll = jfb.forward(jnp.asarray(lb), jnp.asarray(log_a),
                                    jnp.asarray(log_init), int(n), j_fin)
        g_alpha, g_ll = tfb.forward(torch.from_numpy(lb), *t_args, int(n), t_fin)
        _close(g_alpha, w_alpha, f"alpha {i}")
        _close(g_ll, w_ll, f"ll {i}")
        _close(tfb.backward(torch.from_numpy(lb), t_args[0], int(n), t_fin),
               jfb.backward(jnp.asarray(lb), jnp.asarray(log_a), int(n), j_fin), f"beta {i}")
        want = jfb.forward_backward(jnp.asarray(lb), jnp.asarray(log_a),
                                    jnp.asarray(log_init), int(n), j_fin)
        got = tfb.forward_backward(torch.from_numpy(lb), *t_args, int(n), t_fin)
        for w, g, name in zip(want, got, ("gamma", "xi_sum", "ll")):
            _close(g, w, f"{name} {i}")
        # The batched form gives each sequence's posteriors.
        for w, g, name in zip(want, batched, ("gamma", "xi_sum", "ll")):
            _close(g[i], w, f"batched {name} {i}")
        if fin is None:
            _close(tfb.forward_log_likelihood(torch.from_numpy(lb), *t_args, int(n)),
                   jfb.forward_log_likelihood(jnp.asarray(lb), jnp.asarray(log_a),
                                              jnp.asarray(log_init), int(n)), "loglik")


def test_forward_without_length_and_padding_is_a_no_op():
    log_b, log_a, log_init, _lengths, _ = _sequences(2, b=1, t=9)
    lb = torch.from_numpy(log_b[0])
    args = [torch.from_numpy(x) for x in (log_a, log_init)]
    full = tfb.forward_backward(lb, *args)
    # Padding the sequence with garbage frames past its length changes nothing.
    padded = torch.cat([lb, torch.full((5, 5), 40.0)])
    again = tfb.forward_backward(padded, *args, 9)
    _close(again[0][:9], full[0].numpy(), "gamma")
    assert torch.all(again[0][9:] == 0)
    _close(again[1], full[1].numpy(), "xi")
    _close(again[2], full[2].numpy(), "ll")
    want = jfb.forward_backward(jnp.asarray(log_b[0]), jnp.asarray(log_a), jnp.asarray(log_init))
    for w, g in zip(want, full):
        _close(g, w)
