"""The port's data parallelism (cs304_tpu_torch/parallel/data_parallel.py and
the ``mesh=`` of the streaming and serving pools) against the JAX package's
mesh functions, on the CPU.

The port runs SPMD in one group of 4 gloo ranks, spawned once for the module
(tests/torch_ranks.py); every rank runs every case on the same inputs, made
with numpy from seeds. The JAX package runs in the pytest process on
conftest's 8-device virtual CPU mesh (its make_mesh()). Checked:

- the 4 ranks' outputs are bitwise identical to each other;
- dp_kmeans_step: counts equal, means rtol 1e-4 / atol 1e-5, log_a rtol
  1e-5 / atol 1e-6 (tests/test_parallel.py:31-50); the covariances, which
  both packages recentre the same way, rtol 1e-4 / atol 1e-5 (measured max
  |delta| 4e-7), and against the port's single-device two-pass step at
  JAX's own rtol 5e-2 / atol 5e-3;
- dp_embedded_stats (tests/test_parallel.py:84-125): counts and transition
  counts and paths equal, sums rtol 1e-4 / atol 1e-4;
- dp_composite_decode (tests/test_parallel.py:53-81): paths equal, scores
  rtol 1e-5 / atol 1e-4;
- train_word_hmm(mesh=) (tests/test_parallel.py:172-189): iterations equal,
  means rtol 1e-4 / atol 1e-4, covariances rtol 1e-4 / atol 1e-5 (the same
  recentred form on both sides), nan score;
- the streaming pool and ServingSessionPool over the mesh: finals and
  partials equal to the same pool without a mesh
  (tests/test_streaming_batch.py:181-200, tests/test_serving.py:235-255)
  and the pool's finals equal to JAX's mesh pool's;
- the ValueErrors, and a rank given a device= that disagrees with its
  mesh device;
- on a 1-rank mesh in this process: dp_composite_decode, the pool and the
  trainers bitwise the port's single-device path.

tests/test_torch_parallel_train.py holds the trainers over the 4 ranks.
"""
import numpy as np
import pytest
import torch

from cs304_tpu_torch.models.hmm import WordHMM, uniform_forward_log_a
from torch_ranks import run_ranks, same_bits
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

WORLD = 4


# -- inputs (numpy, seeded; no JAX) ---------------------------------------------

def _kmeans_inputs(seed=0, b=16, t=40, d=6, s=4):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(s, d)).astype(np.float32) * 2
    covs = np.tile(np.eye(d, dtype=np.float32) * 0.5, (s, 1, 1))
    batch = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = rng.integers(t // 2, t, size=b).astype(np.int32)
    return means, covs, uniform_forward_log_a(s), batch, lengths


def _decode_inputs(seed=1, b=8, t=30, d=5):
    """Two words of 3 states each (tests/test_parallel.py:53-81)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(6, d)).astype(np.float32) * 2
    covs = np.tile(np.eye(d, dtype=np.float32), (6, 1, 1))
    log_a = np.full((6, 6), -np.inf, np.float32)
    log_a[:3, :3] = uniform_forward_log_a(3)
    log_a[3:, 3:] = uniform_forward_log_a(3)
    lower = np.array([0, 0, 0, 3, 3, 3], np.int32)
    entry = np.array([1, 0, 0, 1, 0, 0], bool)
    exit_ = np.array([0, 0, 1, 0, 0, 1], bool)
    batch = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    return means, covs, log_a, lower, entry, exit_, np.float32(-3.0), batch, lengths


def _embedded_inputs(seed=2, b=16, t=24, d=4):
    """The sentence "SAS" over a 3-state A and a 2-state S
    (tests/test_parallel.py:84-125)."""
    from cs304_tpu_torch.models.train_continuous import _sentence_log_a, _topology

    rng = np.random.default_rng(seed)
    topo = _topology("SAS", {"A": 3, "S": 2}, {"A": 0, "S": 1})
    log_a_g = np.stack([uniform_forward_log_a(3),
                        np.pad(uniform_forward_log_a(2), ((0, 1), (0, 1)),
                               constant_values=-np.inf)])
    means_g = rng.normal(size=(2, 3, d)).astype(np.float32) * 2
    covs_g = np.tile(np.eye(d, dtype=np.float32), (2, 3, 1, 1))
    return (means_g[topo.lab_of_state, topo.loc_of_state],
            covs_g[topo.lab_of_state, topo.loc_of_state], _sentence_log_a(topo, log_a_g),
            topo.lab_of_state, topo.loc_of_state, topo.pos_of_state,
            rng.normal(size=(b, t, d)).astype(np.float32), np.full(b, t, np.int32))


def _word_sequences(seed=3):
    """6 utterances of a 3-state word (not a multiple of 4 or 8: padding)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, 4)) * 4
    seqs = []
    for _ in range(6):
        frames = [centers[s] + rng.normal(0, 0.3, 4)
                  for s in range(3) for _ in range(rng.integers(3, 7))]
        seqs.append(np.asarray(frames, np.float32))
    return seqs


def _pool_models(seed=11, d=6):
    rng = np.random.default_rng(seed)
    out = []
    for label in ("1", "2", "S"):
        s = 2 if label == "S" else 3
        out.append(WordHMM(label=label,
                           means=(rng.normal(size=(s, d)) * 2.0).astype(np.float32),
                           covariances=np.tile(np.eye(d, dtype=np.float32), (s, 1, 1)),
                           log_a=uniform_forward_log_a(s)))
    return out


def _pool_utterances(models, n=6, seed=12):
    rng = np.random.default_rng(seed)
    means = np.concatenate([m.means for m in models])
    out = []
    for _ in range(n):
        picks = means[rng.integers(0, len(means), int(rng.integers(12, 40)))]
        out.append((picks + rng.normal(0, 0.3, picks.shape)).astype(np.float32))
    return out


def _serving_audio():
    from cs304_tpu_torch.data.synthetic import SyntheticTIDigits

    corpus = SyntheticTIDigits(num_train_speakers=2, num_test_speakers=1,
                               takes_per_digit=1, with_sentences=True)
    out = []
    for speaker, transcripts in ((0, ["37", "12"]), (1, ["5"])):
        rng = np.random.default_rng(speaker)
        pieces = [rng.normal(0, 20.0, 4800).astype(np.float32)]
        for i, tr in enumerate(transcripts):
            pieces.append(corpus.sentence_audio(tr, speaker, jitter_seed=i))
            pieces.append(rng.normal(0, 20.0, 8000).astype(np.float32))
        out.append(np.concatenate(pieces))
    return out


# -- what every rank runs ----------------------------------------------------------

def _np(xs):
    return tuple(x.cpu().numpy() for x in xs)


def kmeans_case(mesh, payload):
    from cs304_tpu_torch.parallel.data_parallel import dp_kmeans_step

    return _np(dp_kmeans_step(*_kmeans_inputs(), mesh, 4))


def embedded_case(mesh, payload):
    from cs304_tpu_torch.parallel.data_parallel import dp_embedded_stats

    return _np(dp_embedded_stats(*_embedded_inputs(), mesh, 2, 3))


def decode_case(mesh, payload):
    from cs304_tpu_torch.parallel.data_parallel import dp_composite_decode

    return _np(dp_composite_decode(*_decode_inputs(), mesh))


def word_hmm_case(mesh, payload):
    from cs304_tpu_torch.models.train_kmeans import SegmentalKMeansConfig, train_word_hmm

    cfg = SegmentalKMeansConfig(num_states=3, max_iterations=6, length_multiple=8)
    r = train_word_hmm("X", _word_sequences(), cfg, mesh=mesh)
    return (r.model.means, r.model.covariances, r.model.log_a, r.iterations, r.converged,
            r.final_score)


def _drive_pool(pool, utts):
    """Staggered streams in chunks of up to 8 frames, step-fused partials
    polled after every step, one stream released and its slot reused, then
    finalize -> (finals, polls)."""
    slots = [pool.start() for _ in utts[:4]]
    polls = []
    for lo in range(0, 40, 8):
        feeds = {s: utts[i][lo: lo + 8 - i % 3] for i, s in enumerate(slots)
                 if lo < len(utts[i])}
        feeds = {s: f for s, f in feeds.items() if len(f)}
        pool.step(feeds, partials=True)
        polls.append(pool.partial_texts(slots))
        polls.append(pool.partial_texts(slots, stale_ok=True))
        if lo == 16:
            pool.release(slots[1])
            slots[1] = pool.start()
            pool.step({slots[1]: utts[4][:8]})
    live = [s for s in slots if pool.fill_of(s)]
    finals = pool.finalize(live)
    return {s: finals[s] for s in live}, polls


def pool_case(mesh, payload):
    from cs304_tpu_torch.ops.streaming_batch import BatchedStreamingComposite

    models = _pool_models()
    utts = _pool_utterances(models)
    out = {}
    for step_impl in ("dense", "banded"):
        for name, kw in (("mesh", dict(mesh=mesh)), ("single", dict(device="cpu"))):
            pool = BatchedStreamingComposite.from_models(
                models, penalty=-5.0, num_slots=8, chunk_size=8, max_frames=64,
                step_impl=step_impl, **kw)
            out[(step_impl, name)] = _drive_pool(pool, utts)
    return out


def _drain(pool, audio, chunk=1600):
    sessions = [pool.open() for _ in audio]
    results = {s: [] for s in sessions}
    polls = []
    for off in range(0, max(len(a) for a in audio), chunk):
        done = pool.feed({s: a[off: off + chunk] for s, a in zip(sessions, audio)
                          if off < len(a)})
        for s, rs in done.items():
            results[s] += [(r.text, r.num_samples, r.last_partial) for r in rs]
        polls.append(pool.partials(sessions))
    return [results[s] for s in sessions], polls


def serving_case(mesh, payload):
    from cs304_tpu_torch.models.hmm import flagship_models
    from cs304_tpu_torch.serving import ServingSessionPool

    models = flagship_models()
    return {name: _drain(ServingSessionPool(models, num_slots=8, **kw), payload["audio"])
            for name, kw in (("mesh", dict(mesh=mesh)), ("single", dict(device="cpu")))}


def errors_case(mesh, payload):
    """What each refused call raised: (exception type name, message, the
    rank's number masked)."""
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig, ContinuousTrainer
    from cs304_tpu_torch.ops.streaming_batch import BatchedStreamingComposite
    from cs304_tpu_torch.parallel.data_parallel import (
        dp_composite_decode,
        dp_kmeans_step,
        mesh_rank,
    )
    from cs304_tpu_torch.serving import ServingSessionPool

    models = {m.label: m for m in _pool_models()}
    calls = {
        "pool_slots": lambda: BatchedStreamingComposite.from_models(
            models, num_slots=6, mesh=mesh),
        "pool_sparse": lambda: BatchedStreamingComposite.from_models(
            models, num_slots=8, sparse_upload=True, mesh=mesh),
        "serving_slots": lambda: ServingSessionPool(list(models.values()), num_slots=6,
                                                    mesh=mesh),
        "decode_b6": lambda: dp_composite_decode(*_decode_inputs(b=6), mesh),
        "kmeans_b6": lambda: dp_kmeans_step(*_kmeans_inputs(b=6), mesh, 4),
        "legacy": lambda: ContinuousTrainer(models, ContinuousTrainConfig(fused=False),
                                            mesh=mesh),
        "trainer_device": lambda: ContinuousTrainer(models, mesh=mesh, device="cuda"),
        "pool_device": lambda: BatchedStreamingComposite.from_models(
            models, num_slots=8, mesh=mesh, device="cuda:0"),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the type is the result
            out[name] = (type(e).__name__, str(e).replace(f"rank {mesh_rank(mesh)}", "rank r"))
    return out


CASES = (kmeans_case, embedded_case, decode_case, word_hmm_case, pool_case, serving_case,
         errors_case)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's result on each of the 4 ranks (one spawned group)."""
    return run_ranks(CASES, {"audio": _serving_audio()}, WORLD,
                     tmp_path_factory.mktemp("ranks"))


def result(ranks, case):
    """The case's result, after checking every rank holds the same bits."""
    first = ranks[0][case.__name__]
    for rank, res in enumerate(ranks[1:], 1):
        assert same_bits(res[case.__name__], first), f"rank {rank} differs from rank 0"
    return first


def _jax_mesh():
    from cs304_tpu.parallel.data_parallel import make_mesh

    return make_mesh()


# -- the 4 ranks against JAX's 8-device mesh ------------------------------------------

def test_dp_kmeans_step_matches_jax(ranks):
    import jax.numpy as jnp
    from cs304_tpu.parallel.data_parallel import dp_kmeans_step as j_step
    from cs304_tpu_torch.models.train_kmeans import kmeans_step

    means, covs, log_a, counts = result(ranks, kmeans_case)
    want = j_step(*map(jnp.asarray, _kmeans_inputs()), _jax_mesh(), 4)
    w_means, w_covs, w_log_a, w_counts = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(counts, w_counts)
    np.testing.assert_allclose(means, w_means, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(covs, w_covs, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.isfinite(log_a), np.isfinite(w_log_a))
    fin = np.isfinite(w_log_a)
    np.testing.assert_allclose(log_a[fin], w_log_a[fin], rtol=1e-5, atol=1e-6)
    # The single-device step's two-pass covariance, at JAX's own bounds.
    inputs = [torch.as_tensor(x) for x in _kmeans_inputs()]
    s_means, s_covs, _la, s_counts, _sc = kmeans_step(*inputs, 4, 0.001)
    np.testing.assert_array_equal(counts, s_counts.numpy())
    np.testing.assert_allclose(means, s_means.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(covs, s_covs.numpy(), rtol=5e-2, atol=5e-3)


def test_dp_embedded_stats_matches_jax(ranks):
    import jax.numpy as jnp
    from cs304_tpu.parallel.data_parallel import dp_embedded_stats as j_stats

    counts, sums, trans, paths = result(ranks, embedded_case)
    want = [np.asarray(x) for x in j_stats(*map(jnp.asarray, _embedded_inputs()),
                                           _jax_mesh(), 2, 3)]
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_allclose(sums, want[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(trans, want[2])
    np.testing.assert_array_equal(paths, want[3])


def test_dp_composite_decode_matches_jax(ranks):
    import jax.numpy as jnp
    from cs304_tpu.parallel.data_parallel import dp_composite_decode as j_decode

    scores, paths = result(ranks, decode_case)
    w_scores, w_paths = (np.asarray(x) for x in j_decode(
        *map(jnp.asarray, _decode_inputs()), _jax_mesh()))
    np.testing.assert_array_equal(paths, w_paths)
    np.testing.assert_allclose(scores, w_scores, rtol=1e-5, atol=1e-4)


def test_train_word_hmm_mesh_matches_jax(ranks):
    from cs304_tpu.models.train_kmeans import SegmentalKMeansConfig, train_word_hmm

    means, covs, log_a, iterations, converged, score = result(ranks, word_hmm_case)
    cfg = SegmentalKMeansConfig(num_states=3, max_iterations=6, length_multiple=8)
    want = train_word_hmm("X", _word_sequences(), cfg, mesh=_jax_mesh())
    assert (iterations, converged) == (want.iterations, want.converged)
    assert np.isnan(score) and np.isnan(want.final_score)
    np.testing.assert_allclose(means, want.model.means, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(covs, want.model.covariances, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.isfinite(log_a), np.isfinite(want.model.log_a))


def test_pool_over_mesh_matches_single_and_jax(ranks):
    from cs304_tpu.models.hmm import WordHMM as JWordHMM
    from cs304_tpu.ops.streaming_batch import BatchedStreamingComposite as JPool

    got = result(ranks, pool_case)
    for step_impl in ("dense", "banded"):
        finals, polls = got[(step_impl, "mesh")]
        assert (finals, polls) == got[(step_impl, "single")], step_impl
        assert any(p for poll in polls for p in poll.values())
    # JAX's pool sharded over its 8 devices, fed the same frames.
    models = _pool_models()
    pool = JPool.from_models(
        {m.label: JWordHMM(m.label, m.means, m.covariances, m.log_a) for m in models},
        penalty=-5.0, num_slots=8, chunk_size=8, max_frames=64, mesh=_jax_mesh())
    want, _polls = _drive_pool(pool, _pool_utterances(models))
    finals, _polls = got[("dense", "mesh")]
    assert {s: t for s, (_sc, t) in finals.items()} == {s: t for s, (_sc, t) in want.items()}
    for s, (sc, _t) in finals.items():
        np.testing.assert_allclose(sc, want[s][0], rtol=1e-5)


def test_serving_over_mesh_matches_single(ranks):
    got = result(ranks, serving_case)
    results, polls = got["mesh"]
    assert (results, polls) == got["single"]
    assert [len(r) for r in results] == [2, 1]
    assert any(p for poll in polls for p in poll.values()), "partials while speaking"


def test_mesh_errors(ranks):
    got = result(ranks, errors_case)
    assert all(err is not None and err[0] == "ValueError" for err in got.values()), got
    assert "divide" in got["pool_slots"][1] and "divide" in got["serving_slots"][1]
    assert "sparse_upload" in got["pool_sparse"][1]
    assert "fused=True" in got["legacy"][1]
    for name in ("trainer_device", "pool_device"):
        assert "disagrees with rank r's mesh device 'cpu'" in got[name][1], name


# -- one rank, in this process: bitwise the single-device port ----------------------

@pytest.fixture(scope="module")
def one_rank():
    import torch.distributed as dist
    from cs304_tpu_torch.parallel.data_parallel import make_mesh

    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()  # the card by default, and no card here
    mesh = make_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def test_one_rank_decode_and_pool_bitwise_single(one_rank):
    from cs304_tpu_torch.ops.cuda.trellis_dense import viterbi_composite_batch_pallas
    from cs304_tpu_torch.ops.gaussian import gaussian_log_pdf, make_gaussian_params
    from cs304_tpu_torch.parallel.data_parallel import dp_composite_decode, mesh_size

    assert mesh_size(one_rank) == 1
    means, covs, log_a, lower, entry, exit_, pen, batch, lengths = _decode_inputs()
    got = dp_composite_decode(means, covs, log_a, lower, entry, exit_, pen, batch, lengths,
                              one_rank)
    log_b = gaussian_log_pdf(make_gaussian_params(means, covs), torch.as_tensor(batch))
    want = viterbi_composite_batch_pallas(log_b, log_a, lower, entry, exit_, pen,
                                          torch.as_tensor(lengths))
    assert same_bits(_np(got), _np(want))
    out = pool_case(one_rank, None)
    for step_impl in ("dense", "banded"):
        assert same_bits(out[(step_impl, "mesh")], out[(step_impl, "single")])


def test_one_rank_trainers_bitwise_single(one_rank):
    from cs304_tpu_torch.models.train_continuous import ContinuousTrainConfig, ContinuousTrainer
    from cs304_tpu_torch.models.train_continuous_gmm import (
        GMMContinuousTrainConfig,
        GMMContinuousTrainer,
        promote_to_gmm,
    )
    from test_torch_parallel_train import make_corpus, make_models

    models = make_models()
    labeled = make_corpus(models)
    for update in ("viterbi", "baum_welch"):
        cfg = ContinuousTrainConfig(max_iterations=3, silence_bootstrap=False, cov_reg=0.05,
                                    length_multiple=8, update=update)
        runs = [ContinuousTrainer(make_models(), cfg, **kw)
                for kw in (dict(mesh=one_rank), dict(device="cpu"))]
        its = [tr.train(labeled) for tr in runs]
        assert its[0] == its[1], update
        for name in ("means_g", "covs_g", "log_a_g"):
            assert same_bits(getattr(runs[0], name), getattr(runs[1], name)), (update, name)
    gmm = [GMMContinuousTrainer(promote_to_gmm(make_models(), 2),
                                GMMContinuousTrainConfig(max_iterations=2, cov_reg=0.05), **kw)
           for kw in (dict(mesh=one_rank), dict(device="cpu"))]
    assert gmm[0].train(labeled) == gmm[1].train(labeled)
    for name in ("means_g", "covs_g", "weights_g", "log_a_g"):
        assert same_bits(getattr(gmm[0], name), getattr(gmm[1], name)), name
