"""The Baum-Welch E-step of the port (ops/cuda/trellis_fb.py:
banded_fb_posteriors_plain, the plain version of the kernel's E-step mode)
against the JAX package: its sentence forward-backward
(cs304_tpu/models/train_fused.py:_banded_fb_batch) followed by its own
posterior formulas (gamma_of and the xi loop of _bw_body), on the same numpy
inputs; the kernel's cheaper lse3 emulated in torch; the xi sum's order and
masks; the trainer's n_states check.

Tolerances:
  - gamma and the xi sums against JAX: within rtol 1e-4 / atol 1e-6, and
    exactly +0 wherever JAX's term is a structural zero (a masked frame or
    pair, or a -inf exponent). alpha, beta and ll agree to rtol 1e-5 /
    atol 1e-4 (tests/test_torch_train_bw.py), and an exponent error of
    1e-5..1e-4 on values of size |ll| ~ 1e1..1e2 moves exp by as much
    relative; the sums add up to T - 1 such terms.
  - ll against JAX: -inf in the same places, the rest rtol 1e-5 /
    atol 1e-4 (as test_torch_train_bw.py holds FB).
  - the "1.0f for the max term" lse3 and the xi order and masks: bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs304_tpu.models import train_fused as jf
from cs304_tpu_torch.models import train_fused as tf
from cs304_tpu_torch.models.train_continuous import ContinuousTrainer, insert_silence
from cs304_tpu_torch.ops.cuda import trellis_banded as tb
from cs304_tpu_torch.ops.cuda import trellis_fb as tfb
from test_torch_train_bw import _fb_problem, _iteration_args
from test_torch_train_fused import make_corpus, make_models, setup  # noqa: F401

NEG = float("-inf")


def _jax_posteriors(log_b, c0, c1, c2, lengths, n_states):
    """JAX's E-step: _banded_fb_batch, then gamma_of and the xi loop of
    cs304_tpu/models/train_fused.py:_bw_body (without the same-word mask,
    which the port applies after the sum), and the structural zeros."""
    t = log_b.shape[1]
    la, be, ll = (np.asarray(x) for x in jf._banded_fb_batch(
        *(jnp.asarray(x) for x in (log_b, c0, c1, c2, lengths, n_states))))
    la_j, be_j = jnp.asarray(la), jnp.asarray(be)
    valid = jnp.isfinite(jnp.asarray(ll))
    llc = jnp.where(valid, jnp.asarray(ll), 0.0)
    lc = jnp.asarray(lengths)
    mask = (jnp.arange(t)[None, :] < lc[:, None]) & valid[:, None]
    expo = la_j + be_j - llc[:, None, None]
    gamma = jnp.where(mask[..., None], jnp.exp(expo), 0.0)
    gamma_zero = ~mask[..., None] | jnp.isneginf(expo)
    pair_mask = (jnp.arange(t - 1)[None, :, None] + 1 < lc[:, None, None]) & valid[:, None, None]
    zb = jnp.asarray(log_b)[:, 1:] + be_j[:, 1:]
    xis, xi_zero = [], []
    for k, ck in enumerate((c0, c1, c2)):
        if k == 0:
            a_shift = la_j[:, :-1]
        else:
            a_shift = jnp.concatenate(
                [jnp.full((la.shape[0], t - 1, k), NEG), la_j[:, :-1, :-k]], axis=2)
        log_xi = a_shift + jnp.asarray(ck)[:, None, :] + zb - llc[:, None, None]
        live = pair_mask & ~jnp.isneginf(log_xi)
        xis.append(jnp.sum(jnp.where(pair_mask, jnp.exp(log_xi), 0.0), axis=1))
        xi_zero.append(~live.any(axis=1))
    return (np.asarray(gamma), np.stack([np.asarray(x) for x in xis], 1), ll,
            np.asarray(gamma_zero), np.stack([np.asarray(z) for z in xi_zero], 1))


def _final(n_states, s):
    return torch.clamp(torch.from_numpy(n_states) - 1, min=0).to(torch.int32)


@pytest.mark.parametrize("case", [(6, 20, 11, False), (9, 17, 3, True), (5, 1, 7, False),
                                  (4, 12, 2, True), (7, 24, 5, True)])
def test_posteriors_plain_matches_jax(case):
    """-inf in log_b and c1/c2, length-0 and -1 rows, T = 1, S = 2 (the JAX
    forward-backward takes S >= 2)."""
    b, t, s, zero = case
    prob = _fb_problem(b, t, s, seed=b * 31 + t, zero_length=zero)
    gamma_j, xi_j, ll_j, gamma_zero, xi_zero = _jax_posteriors(*prob)
    args = [torch.from_numpy(x) for x in prob[:5]] + [_final(prob[5], s)]
    gamma, xi, ll = tfb.banded_fb_posteriors_plain(*args)
    assert gamma.shape == (b, t, s) and xi.shape == (b, 3, s) and ll.shape == (b,)
    np.testing.assert_array_equal(np.isfinite(ll_j), np.isfinite(ll.numpy()))
    fin = np.isfinite(ll_j)
    np.testing.assert_allclose(ll.numpy()[fin], ll_j[fin], rtol=1e-5, atol=1e-4)
    for got, want, zero_cells, name in ((gamma, gamma_j, gamma_zero, "gamma"),
                                        (xi, xi_j, xi_zero, "xi")):
        got = got.numpy()
        assert not np.isnan(got).any(), name
        assert (got[zero_cells] == 0).all() and not np.signbit(got[zero_cells]).any(), name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)
    # The wrapper on CPU tensors is the same plain version; no launch counted.
    before = tfb.banded_fb_posteriors.launches
    again = tfb.banded_fb_posteriors(*args)
    assert tfb.banded_fb_posteriors.launches == before
    for g, a in zip((gamma, xi, ll), again):
        assert torch.equal(g, a)


def _lse3_max_one(a, b, c):
    """The kernel's lse3 (csrc/trellis_fb.cu), emulated: the max operand's
    exp(m - m) stands as 1.0 in its own slot of ((e_a + e_b) + e_c)."""
    m = torch.maximum(torch.maximum(a, b), c)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    slot = torch.where(a == m, 0, torch.where(b == m, 1, 2))
    ep = torch.exp(torch.where(slot == 0, b, a) - m_safe)
    eq = torch.exp(torch.where(slot == 2, b, c) - m_safe)
    one = torch.ones_like(m)
    total = torch.where(slot == 2, (ep + eq) + one, (ep + one) + eq)
    return torch.where(fin, m_safe + torch.log(total), torch.full_like(m, NEG))


def _lse3_operands(kind, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=n).astype(np.float32) * 30 for _ in range(3)]
    if kind == "tied":
        # every tie pattern: two or three operands equal, max or not
        xs[1][: n // 2] = xs[0][: n // 2]
        xs[2][n // 4: 3 * n // 4] = xs[1][n // 4: 3 * n // 4]
        xs = [np.round(x) for x in xs]
    elif kind == "neg_inf":
        for x in xs:
            x[rng.random(n) < 0.4] = NEG
    elif kind == "all_neg_inf":
        xs = [np.full(n, NEG, np.float32) for _ in range(3)]
        xs[0][: n // 8] = 0.0
    return [torch.from_numpy(x.astype(np.float32)) for x in xs]


@pytest.mark.parametrize("kind", ["random", "tied", "neg_inf", "all_neg_inf"])
def test_lse3_with_one_for_the_max_term_is_bitwise(kind):
    a, b, c = _lse3_operands(kind)
    want = tfb.lse3(a, b, c)
    got = _lse3_max_one(a, b, c)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if kind == "all_neg_inf":
        assert torch.isneginf(want[want.numel() // 8:]).all()


def test_xi_order_and_masks_over_a_shift_states_reference():
    """The plain E-step's xi is, bitwise, the sum of shift_states terms from
    the last pair down to the first with the pair mask inside; masking by a
    same-word table after the sum equals masking every term; torch's own
    sum order differs only by rounding."""
    b, t, s = 7, 19, 9
    prob = _fb_problem(b, t, s, seed=11, zero_length=True)
    args = [torch.from_numpy(x) for x in prob[:5]] + [_final(prob[5], s)]
    log_b, cs, lengths = args[0], args[1:4], args[4]
    alpha, beta, ll = tfb.banded_fb_plain(*args)
    _gamma, xi, _ll = tfb.banded_fb_posteriors_plain(*args)
    valid = torch.isfinite(ll)
    llc = torch.where(valid, ll, torch.zeros_like(ll))
    rng = np.random.default_rng(4)
    samew = torch.from_numpy(rng.random((b, s)) < 0.6)
    pair = ((torch.arange(t - 1)[None, :] + 1 < lengths[:, None]) & valid[:, None])
    for k in range(3):
        a_shift = tfb.shift_states(alpha[:, :-1], k)
        terms = torch.exp(a_shift + cs[k][:, None, :] + (log_b[:, 1:] + beta[:, 1:])
                          - llc[:, None, None])
        inside = pair[..., None] & samew[:, None, :]
        acc = torch.zeros((b, s))
        for tt in range(t - 2, -1, -1):
            acc = acc + torch.where(inside[:, tt], terms[:, tt], torch.zeros(()))
        after = torch.where(samew, xi[:, k], torch.zeros(()))
        assert torch.equal(acc.view(torch.int32), after.view(torch.int32)), k
        unmasked = torch.where(pair[..., None], terms, torch.zeros(())).sum(dim=1)
        torch.testing.assert_close(xi[:, k], unmasked, rtol=1e-6, atol=1e-7)
        assert (xi[:, k][:, :k] == 0).all()  # alpha_t[v - k] = -inf for v < k


def test_training_e_step_backends_agree_on_cpu(setup):
    """One fused Baum-Welch iteration on CPU tensors gives the same
    parameters with _FB_BACKEND "kernel" (the wrapper's plain dispatch) and
    "plain"; no kernel launch is counted; an unknown backend raises."""
    st = setup["st"]
    kw = dict(cov_reg=0.05, rtol=1e-5, atol=1e-8, num_labels=len(st.labels),
              s_max=st.s_max, cross_word="exit_only")
    counters = (tfb.banded_fb, tfb.banded_fb_posteriors)
    before = [c.launches for c in counters]
    saved = tf._FB_BACKEND
    try:
        assert saved == "kernel"
        got_k = tf.fused_bw_iteration(*_iteration_args(setup, "torch"), **kw)
        tf._FB_BACKEND = "plain"
        got_p = tf.fused_bw_iteration(*_iteration_args(setup, "torch"), **kw)
        tf._FB_BACKEND = "bogus"
        with pytest.raises(ValueError):
            tf.fused_bw_iteration(*_iteration_args(setup, "torch"), **kw)
    finally:
        tf._FB_BACKEND = saved
    for g, p in zip(got_k, got_p):
        assert torch.equal(g, p)
    assert [c.launches for c in counters] == before


def test_bad_n_states_still_raise_for_direct_callers():
    """The trainer takes final states unchecked (n_states <= S_sent holds by
    construction, and a check would sync with the card every iteration);
    every direct caller keeps the ValueError."""
    b, t, s = 4, 9, 6
    prob = [torch.from_numpy(x) for x in _fb_problem(b, t, s, seed=3)]
    bad = prob[5] + s
    with pytest.raises(ValueError, match="n_states"):
        tb.final_states(bad, s)
    with pytest.raises(ValueError, match="n_states"):
        tf._banded_fb_batch(*prob[:5], bad)
    with pytest.raises(ValueError, match="n_states"):
        tf._banded_trellis_batch(*prob[:5], bad)
    with pytest.raises(ValueError, match="n_states"):
        tb.viterbi_banded_batch_scanfree(*prob[:5], bad)
    # On prepare_fused_corpus's tables the trainer's unchecked finals are
    # final_states' checked ones.
    models = make_models(seed=2)
    trainer = ContinuousTrainer(models, device="cpu")
    corpus = tf.prepare_fused_corpus(make_corpus(models, ["12", "3"], 2, seed=5),
                                     trainer.state_counts, trainer.label_index,
                                     insert_silence, 32, device="cpu")
    s_sent = corpus.lab_tab.shape[1]
    log_b = torch.zeros((len(corpus.n_states_t), 1, s_sent))
    _lengths, final = tf._training_args(log_b, torch.ones(len(corpus.n_states_t)),
                                        corpus.n_states_t)
    assert torch.equal(final, tb.final_states(corpus.n_states_t, s_sent))
