"""The port's batched streaming pool (cs304_tpu_torch/ops/streaming_batch.py)
against the JAX package's (cs304_tpu/ops/streaming_batch.py), on the CPU.

- The plain steps (_advance, _advance_banded, _advance_compact) and the
  wrappers the pool runs (stream_advance and the K4 dense step, on CPU
  tensors their plain versions) are bitwise JAX's steps on the same log_b:
  alpha with its signs of zero, and the ring.
- Pools fed the same features: finalize, partial_texts (exact and
  stale_ok), fill, the ring dtype, the capacity and chunk errors, "auto"
  step_impl and the compact against the dense upload give JAX's texts, with
  scores within rel 1e-5 (emissions differ in the last bits between the two
  frameworks; tests/test_streaming_batch.py holds the JAX pool so).
- mesh= takes a data-parallel mesh (tests/test_torch_parallel.py holds
  the pool over one); anything else is a TypeError.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.models.hmm import WordHMM as JaxWordHMM
from cs304_tpu.ops import streaming_batch as jsb
from cs304_tpu.ops.viterbi import composite_transition_matrix as jax_trans
from cs304_tpu_torch.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a
from cs304_tpu_torch.ops import streaming_batch as tsb
from cs304_tpu_torch.ops.cuda import trellis_stream as tst
from cs304_tpu_torch.ops.viterbi import composite_transition_matrix, pack_coefs

jax.config.update("jax_platforms", "cpu")
# JAX's steps compiled once per shape (eager, each lax.scan traces anew).
_jax_advance = jax.jit(jsb._advance)
_jax_advance_banded = jax.jit(jsb._advance_banded)
_jax_advance_compact = jax.jit(jsb._advance_compact)


def _models(seed=0, labels=("1", "2", "S"), d=6):
    rng = np.random.default_rng(seed)
    out = []
    for label in sorted(labels):
        s = 2 if label == "S" else 3
        out.append(WordHMM(label=label,
                           means=(rng.normal(size=(s, d)) * 2.0).astype(np.float32),
                           covariances=np.tile(np.eye(d, dtype=np.float32), (s, 1, 1)),
                           log_a=uniform_forward_log_a(s)))
    return out


def _jax_models(models):
    return {m.label: JaxWordHMM(label=m.label, means=m.means, covariances=m.covariances,
                                log_a=m.log_a) for m in models}


def _utterances(models, n, rng):
    means = np.concatenate([m.means for m in models])
    out = []
    for _ in range(n):
        t = int(rng.integers(12, 40))
        picks = means[rng.integers(0, len(means), t)]
        out.append((picks + rng.normal(0, 0.3, picks.shape)).astype(np.float32))
    return out


def _plan(utts, rng, chunk):
    """Staggered starts and uneven chunks: a list of {utterance: frames}."""
    cursors = [0] * len(utts)
    plan, step = [], 0
    while any(cursors[i] < len(u) for i, u in enumerate(utts)):
        feeds = {}
        for i, u in enumerate(utts):
            if step < i or cursors[i] >= len(u):
                continue
            c = int(rng.integers(1, chunk + 1))
            feeds[i] = u[cursors[i]: cursors[i] + c]
            cursors[i] += len(feeds[i])
        plan.append(feeds)
        step += 1
    return plan


def _pools(models, **kw):
    kw = dict(penalty=-5.0, num_slots=4, chunk_size=8, max_frames=64) | kw
    return (jsb.BatchedStreamingComposite.from_models(_jax_models(models), **kw),
            tsb.BatchedStreamingComposite.from_models(models, device="cpu", **kw))


def _same_results(want, got):
    assert set(want) == set(got)
    for slot, (score, text) in want.items():
        assert got[slot][1] == text, slot
        assert got[slot][0] == pytest.approx(score, rel=1e-5), slot


# -- the plain steps, bitwise ---------------------------------------------------


@pytest.mark.parametrize("penalty,ties", [(-5.0, False), (0.0, True)])
def test_plain_steps_are_bitwise_jax(penalty, ties):
    """_advance (and the K4 dense step's glue), _advance_banded (and
    stream_advance) and _advance_compact, dense and banded, over staggered
    clocks, idle slots, a reseeded slot and padding rows."""
    comp = stack_word_models(_models(seed=1, labels=("1", "2", "3", "S")), penalty)
    s, b, t_max, c = comp.num_states, 5, 30, 6
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    coefs = pack_coefs(*topo)
    trans = composite_transition_matrix(*topo, penalty)
    jtopo = tuple(jnp.asarray(x) for x in topo)
    jtr = jax_trans(*jtopo, jnp.float32(penalty))
    jco = jsb._banded_coeffs(*jtopo, jnp.float32(penalty))
    seed, entry = coefs[6], coefs[4] > 0
    jseed, jentry = jnp.asarray(seed.numpy()), jnp.asarray(comp.is_entry)
    rng = np.random.default_rng(7)
    state = {k: (np.full((b, s), -np.inf, np.float32), np.full((b, t_max, s), -1, np.int8))
             for k in ("dense", "banded", "compact_dense", "compact_banded")}
    t = np.array([0, 4, 0, 9, 2], np.int32)
    for step in range(5):
        valid = rng.integers(0, c + 1, b).astype(np.int32)
        if step == 3:
            t[1] = 0  # slot 1 recycled: reseeds from its next frame
        shape = (b, c, s)
        lb = (rng.integers(-2, 1, shape) if ties else rng.normal(size=shape)).astype(np.float32)
        for kind, (alpha, ring) in state.items():
            args = (jnp.asarray(alpha), jnp.asarray(ring))
            if kind == "dense":
                ja, jr, _ = _jax_advance(*args, jnp.asarray(t), jnp.asarray(valid),
                                        jnp.asarray(lb), jtr, jseed, jentry)
                ta, tr, _ = tsb._advance(torch.tensor(alpha), torch.tensor(ring), t, valid,
                                         torch.tensor(lb), trans, seed, entry)
                ka, kr = tst.dense_stream_advance(torch.tensor(alpha), torch.tensor(ring),
                                                  np.arange(b), t, valid, torch.tensor(lb),
                                                  trans, coefs)
            elif kind == "banded":
                ja, jr, _ = _jax_advance_banded(*args, jnp.asarray(t), jnp.asarray(valid),
                                               jnp.asarray(lb), jco, jseed, jentry)
                ta, tr, _ = tsb._advance_banded(torch.tensor(alpha), torch.tensor(ring), t,
                                                valid, torch.tensor(lb),
                                                tsb._coeffs_of(coefs, penalty), seed, entry)
                ka, kr = tst.stream_advance(torch.tensor(alpha), torch.tensor(ring),
                                            torch.arange(b, dtype=torch.int32),
                                            torch.tensor(t), torch.tensor(valid),
                                            torch.tensor(lb), coefs, penalty)
            else:
                # Compact rows: slots 3, 0 and a padding row (slot b, valid 0).
                ids = np.array([3, 0, b], np.int32)
                rows_t = np.array([t[3], t[0], 0], np.int32)
                rows_v = np.array([valid[3], valid[0], 0], np.int32)
                rows_lb = lb[[3, 0, 1]]
                topo_kw = ({"trans": jtr} if kind == "compact_dense" else {"coeffs": jco})
                ja, jr = _jax_advance_compact(*args, jnp.asarray(ids), jnp.asarray(rows_t),
                                              jnp.asarray(rows_v), jnp.asarray(rows_lb),
                                              jseed, jentry, **topo_kw)
                tkw = ({"trans": trans} if kind == "compact_dense"
                       else {"coeffs": tsb._coeffs_of(coefs, penalty)})
                ta, tr = tsb._advance_compact(torch.tensor(alpha), torch.tensor(ring), ids,
                                              rows_t, rows_v, torch.tensor(rows_lb), seed,
                                              entry, **tkw)
                if kind == "compact_dense":
                    ka, kr = tst.dense_stream_advance(
                        torch.tensor(alpha), torch.tensor(ring), ids, rows_t, rows_v,
                        torch.tensor(rows_lb), trans, coefs)
                else:
                    ka, kr = tst.stream_advance(
                        torch.tensor(alpha), torch.tensor(ring), torch.tensor(ids),
                        torch.tensor(rows_t), torch.tensor(rows_v), torch.tensor(rows_lb),
                        coefs, penalty)
            ja, jr = np.asarray(ja), np.asarray(jr)
            for got_a, got_r in ((ta, tr), (ka, kr)):
                np.testing.assert_array_equal(got_a.numpy(), ja)
                np.testing.assert_array_equal(np.signbit(got_a.numpy()), np.signbit(ja))
                np.testing.assert_array_equal(got_r.numpy(), jr)
            state[kind] = (ja.copy(), jr.copy())
        t = t + valid


def test_ring_dtype_matches_jax():
    for s in (1, 58, 127, 128, 503):
        assert np.dtype(jsb.ring_dtype(s)).itemsize == torch.empty(
            0, dtype=tsb.ring_dtype(s)).element_size()
    assert tsb.ring_dtype(127) == torch.int8 and tsb.ring_dtype(128) == torch.int32


# -- pools on the same feeds -----------------------------------------------------


@pytest.mark.parametrize("step_impl", ["dense", "banded"])
def test_pool_finalize_and_fill_match_jax(step_impl):
    """Staggered starts, uneven chunks, a recycled slot: fill and finalize
    equal JAX's pool, and the dense and compact uploads leave the port's
    alpha and ring bitwise equal."""
    models = _models()
    rng = np.random.default_rng(0)
    utts = _utterances(models, 3, rng)
    plan = _plan(utts, rng, 8)
    jpool, tpool = _pools(models, step_impl=step_impl)
    sparse = tsb.BatchedStreamingComposite.from_models(
        models, penalty=-5.0, num_slots=4, chunk_size=8, max_frames=64,
        step_impl=step_impl, sparse_upload=True, device="cpu")
    slots = [(jpool.start(), tpool.start(), sparse.start()) for _ in utts]
    for feeds in plan:
        for k, pool in enumerate((jpool, tpool, sparse)):
            pool.step({slots[i][k]: f for i, f in feeds.items()})
    assert tpool.fill() == jpool.fill() == sparse.fill()
    assert tpool.fill_of(slots[1][1]) == len(utts[1])
    torch.testing.assert_close(tpool._alpha, sparse._alpha, rtol=0, atol=0)
    assert torch.equal(tpool._ring, sparse._ring)
    want = jpool.finalize([s[0] for s in slots])
    _same_results(want, tpool.finalize([s[1] for s in slots]))
    assert tpool.finalize([s[1] for s in slots]) == sparse.finalize([s[2] for s in slots])
    # Recycle slot 0: a fresh stream reseeds from its first frame.
    jpool.release(slots[0][0])
    tpool.release(slots[0][1])
    fresh = (jpool.start(), tpool.start())
    assert fresh == (slots[0][0], slots[0][1])
    u = _utterances(models, 1, rng)[0]
    for lo in range(0, len(u), 8):
        jpool.step({fresh[0]: u[lo: lo + 8]})
        tpool.step({fresh[1]: u[lo: lo + 8]})
    _same_results(jpool.finalize([fresh[0]]), tpool.finalize([fresh[1]]))


def test_pool_partial_texts_exact_and_stale_ok_match_jax():
    """step(partials=True) snapshots: exact polls, stale_ok polls (the
    previous generation), a snapshot gone stale by an unfused step, and a
    released and reused slot (the stream-id guard), all equal JAX's."""
    models = _models(seed=5)
    rng = np.random.default_rng(5)
    utts = _utterances(models, 2, rng)
    jpool, tpool = _pools(models)
    js = [jpool.start() for _ in utts]
    ts = [tpool.start() for _ in utts]
    assert tpool.partial_text(ts[0]) == jpool.partial_text(js[0]) == ""
    for off in range(0, max(len(u) for u in utts), 4):
        feeds = {i: u[off: off + 4] for i, u in enumerate(utts) if off < len(u)}
        jpool.step({js[i]: f for i, f in feeds.items()}, partials=True)
        tpool.step({ts[i]: f for i, f in feeds.items()}, partials=True)
        for stale_ok in (True, False):
            want = jpool.partial_texts(js, stale_ok=stale_ok)
            got = tpool.partial_texts(ts, stale_ok=stale_ok)
            assert [got[s] for s in ts] == [want[s] for s in js]
    extra = _utterances(models, 1, rng)[0][:4]
    jpool.step({js[0]: extra})
    tpool.step({ts[0]: extra})
    assert tpool.partial_text(ts[0]) == jpool.partial_text(js[0])
    for pool, s in ((jpool, js), (tpool, ts)):
        pool.step({s[1]: extra[:2]}, partials=True)
        pool.release(s[1])
        assert pool.start() == s[1]
        pool.step({s[1]: extra[2:]})
    got = tpool.partial_texts(ts, stale_ok=True)
    want = jpool.partial_texts(js, stale_ok=True)
    assert [got[s] for s in ts] == [want[s] for s in js]
    assert tpool.partial_texts([ts[1]])[ts[1]] == jpool.partial_texts([js[1]])[js[1]]


def test_pool_errors_and_auto_step_impl_match_jax():
    models = _models()
    jpool, tpool = _pools(models, num_slots=1, chunk_size=4, max_frames=8)
    assert tpool._ring.dtype == torch.int8 and tpool.step_impl == jpool.step_impl == "dense"
    utt = _utterances(models, 1, np.random.default_rng(2))[0]
    for pool in (jpool, tpool):
        slot = pool.start()
        with pytest.raises(RuntimeError, match="slots busy"):
            pool.start()
        with pytest.raises(ValueError, match="exceeds chunk_size"):
            pool.step({slot: utt[:6]})
        pool.step({slot: utt[:4]})
        pool.step({slot: utt[4:8]})
        with pytest.raises(ValueError, match="max_frames"):
            pool.step({slot: utt[8:12]})
        with pytest.raises(KeyError):
            pool.step({slot + 1: utt[:2]})
        with pytest.raises(ValueError, match="expected"):
            pool.step({slot: utt[:2, :3]})
        pool.release(slot)
        with pytest.raises(KeyError):
            pool.partial_text(slot)
    big = [WordHMM(label=f"w{i:02d}", means=np.full((5, 4), i, np.float32),
                   covariances=np.tile(np.eye(4, dtype=np.float32), (5, 1, 1)),
                   log_a=uniform_forward_log_a(5)) for i in range(30)]
    pool = tsb.BatchedStreamingComposite.from_models(big, num_slots=2, max_frames=32,
                                                    device="cpu")
    assert pool.composite.num_states == 150 and pool.step_impl == "banded"
    assert pool._ring.dtype == torch.int32
    with pytest.raises(ValueError):
        tsb.BatchedStreamingComposite.from_models(models, num_slots=2, step_impl="nope",
                                                 device="cpu")
    with pytest.raises(ValueError):
        tsb.BatchedStreamingComposite.from_models(models, num_slots=2, step_impl="dense",
                                                 emissions="quad", device="cpu")


def test_sparse_auto_picks_per_step_and_quad_emissions_match_jax():
    """sparse_upload="auto" takes the compact rows only for a sparse fed set;
    emissions="quad" on the banded step gives JAX's quad pool's texts."""
    models = _models(seed=9)
    rng = np.random.default_rng(9)
    utts = _utterances(models, 16, rng)
    pool = tsb.BatchedStreamingComposite.from_models(
        models, penalty=-5.0, num_slots=16, chunk_size=8, max_frames=64, device="cpu")
    rows = []
    orig = pool._advance_rows
    pool._advance_rows = lambda ids, *a: (rows.append(len(ids)), orig(ids, *a))[1]
    slots = [pool.start() for _ in utts]
    pool.step({slots[0]: utts[0][:8]})
    pool.step({s: utts[i][:8] for i, s in enumerate(slots)})
    pool.step({s: utts[i][8:16] for i, s in enumerate(slots) if i < 4})
    assert rows == [8, 16, 8]
    jq, tq = _pools(models, step_impl="banded", emissions="quad", num_slots=2)
    js, ts = [jq.start() for _ in utts[:2]], [tq.start() for _ in utts[:2]]
    for lo in range(0, 16, 8):
        jq.step({js[i]: utts[i][lo: lo + 8] for i in range(2)})
        tq.step({ts[i]: utts[i][lo: lo + 8] for i in range(2)})
    want, got = jq.finalize(js), tq.finalize(ts)
    assert [got[s][1] for s in ts] == [want[s][1] for s in js]


def test_unported_options_raise():
    """mesh= takes a data-parallel mesh (tests/test_torch_parallel.py), not
    any object (TypeError); bigram= raised before the search slice was
    ported and now streams as the JAX pool does (its banded LM step;
    tests/test_torch_serving_search.py holds the rest)."""
    from cs304_tpu.ops import lm as jlm
    from cs304_tpu_torch.ops import lm as tlm

    models = _models()
    comp = stack_word_models(models, -5.0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsb.BatchedStreamingComposite(comp, num_slots=2, device="cpu", mesh=object())
    corpus = ["12", "21", "1", "22S1"]
    jpool, tpool = (jsb.BatchedStreamingComposite.from_models(
        _jax_models(models), penalty=-5.0, num_slots=2, chunk_size=8, max_frames=64,
        bigram=jlm.train_word_bigram(corpus, comp.labels), lm_weight=2.0),
        tsb.BatchedStreamingComposite.from_models(
            models, penalty=-5.0, num_slots=2, chunk_size=8, max_frames=64,
            bigram=tlm.train_word_bigram(corpus, comp.labels), lm_weight=2.0,
            device="cpu"))
    assert tpool.step_impl == jpool.step_impl == "banded"
    feats = _utterances(models, 1, np.random.default_rng(4))[0][:16]
    js, ts = jpool.start(), tpool.start()
    for lo in range(0, 16, 8):
        jpool.step({js: feats[lo: lo + 8]})
        tpool.step({ts: feats[lo: lo + 8]})
    _same_results(jpool.finalize([js]), tpool.finalize([ts]))
    # GMM models and gmm_params stream (they raised before GMMs were
    # ported): K = 1 GMMs give the single-Gaussian pool's texts and scores
    # (tests/test_torch_gmm_decode.py holds K = 2 pools against JAX's).
    from cs304_tpu_torch.models.gmm_hmm import GMMWordHMM
    from cs304_tpu_torch.ops.gaussian import make_gmm_params

    gmm = [GMMWordHMM(m.label, m.means[:, None], m.covariances[:, None],
                      np.ones((m.num_states, 1), np.float32), m.log_a) for m in models]
    params = make_gmm_params(comp.means[:, None], comp.covariances[:, None],
                             np.ones((comp.num_states, 1), np.float32), device="cpu")
    feats = _utterances(models, 1, np.random.default_rng(5))[0][:16]
    results = []
    for pool in (tsb.BatchedStreamingComposite(comp, num_slots=2, device="cpu"),
                 tsb.BatchedStreamingComposite(comp, num_slots=2, gmm_params=params,
                                               device="cpu"),
                 tsb.BatchedStreamingComposite.from_models(gmm, penalty=-5.0, num_slots=2,
                                                           device="cpu")):
        slot = pool.start()
        pool.step({slot: feats})
        results.append(pool.finalize([slot])[slot])
    for score, text in results[1:]:
        assert text == results[0][1]
        np.testing.assert_allclose(score, results[0][0], rtol=1e-5)
    # A pair penalty (it raised before the search slice) gives the JAX
    # coefficients' LM tables.
    pair = np.arange(9, dtype=np.float32).reshape(3, 3) - 12.0
    got = tsb._banded_coeffs(comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit,
                             -5.0, pair_penalty=pair, word_of_state=comp.word_of_state,
                             uppers=comp.uppers)
    want = jsb._banded_coeffs(jnp.asarray(comp.log_a), jnp.asarray(comp.lower_of_state),
                              jnp.asarray(comp.is_entry), jnp.asarray(comp.is_exit), -5.0,
                              pair_penalty=pair, word_of_state=comp.word_of_state,
                              uppers=comp.uppers)
    for g, w in zip(got[:4] + got[6], want[:4] + want[6]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
