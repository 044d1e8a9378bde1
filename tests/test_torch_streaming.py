"""The port's single-stream decoder (cs304_tpu_torch/ops/streaming.py)
against the JAX package's StreamingComposite on the CPU: the same features
in the same chunks give the same partial labels after every feed, the same
final path, and a final score within rel 1e-5 (emissions differ in the last
bits between the two frameworks). Given the same log_b, the chunk step (K4's
plain version behind the seed-row layout) is bitwise JAX's _stream_chunk."""
import jax
import numpy as np
import pytest

from cs304_tpu.models.hmm import WordHMM as JaxWordHMM
from cs304_tpu.models.hmm import stack_word_models as jax_stack
from cs304_tpu.ops.streaming import StreamingComposite as JaxStreaming
from cs304_tpu_torch.models.hmm import WordHMM, stack_word_models, uniform_forward_log_a
from cs304_tpu_torch.ops.streaming import StreamingComposite

jax.config.update("jax_platforms", "cpu")


def _models(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for label, s in (("A", 4), ("B", 3), ("S", 2)):
        a = rng.normal(size=(s, 4, 2)).astype(np.float32)
        out.append(WordHMM(label=label,
                           means=(rng.normal(size=(s, 4)) * 2).astype(np.float32),
                           covariances=a @ a.transpose(0, 2, 1) + np.eye(4, dtype=np.float32),
                           log_a=uniform_forward_log_a(s)))
    return out


def _pair(models, penalty=-4.0, chunk_size=16):
    jax_comp = jax_stack([JaxWordHMM(m.label, m.means, m.covariances, m.log_a)
                          for m in models], penalty=penalty)
    return (JaxStreaming(jax_comp, chunk_size=chunk_size),
            StreamingComposite(stack_word_models(models, penalty), chunk_size=chunk_size,
                               device="cpu"))


@pytest.mark.parametrize("chunking", [[37], [10, 10, 10, 7], [1] * 12 + [25], [20, 17]])
def test_streaming_matches_jax(chunking):
    feats = (np.random.default_rng(1).normal(size=(37, 4)) * 2).astype(np.float32)
    want, got = _pair(_models())
    start = 0
    for c in chunking:
        for stream in (want, got):
            stream.feed(feats[start: start + c])
        start += c
        assert got.partial_labels() == want.partial_labels()
        assert got.partial_labels(skip_silence=False) == want.partial_labels(skip_silence=False)
    np.testing.assert_allclose(got.partial_scores(), want.partial_scores(), rtol=1e-5)
    w_score, w_path = want.finalize()
    g_score, g_path = got.finalize()
    np.testing.assert_array_equal(g_path, w_path)
    assert g_score == pytest.approx(w_score, rel=1e-5)


@pytest.mark.parametrize("ties", [False, True])
def test_k4_chunk_step_is_bitwise_jax_stream_chunk(ties):
    """The chunk step (k4_chunk: K4's plain version behind the seed-row
    layout) against JAX's _stream_chunk on the same log_b, chunk by chunk:
    alpha with its signs of zero and every live backpointer row, bitwise."""
    import jax.numpy as jnp
    import torch

    from cs304_tpu.ops.streaming import _stream_chunk
    from cs304_tpu.ops.viterbi import composite_transition_matrix as jax_trans
    from cs304_tpu_torch.ops.cuda.trellis_stream import k4_chunk
    from cs304_tpu_torch.ops.viterbi import composite_transition_matrix, pack_coefs

    comp = stack_word_models(_models(seed=4), -4.0)
    s = comp.num_states
    topo = (comp.log_a, comp.lower_of_state, comp.is_entry, comp.is_exit)
    trans, coefs = composite_transition_matrix(*topo, -4.0), pack_coefs(*topo)
    jtrans = jax_trans(*(jnp.asarray(x) for x in topo), jnp.float32(-4.0))
    rng = np.random.default_rng(8)
    alpha_t = torch.empty((1, s))
    alpha_j, t = None, 0
    for c in (7, 1, 16, 5):
        lb = (rng.integers(-2, 1, (16, s)) if ties else 3 * rng.normal(size=(16, s)))
        lb = lb.astype(np.float32)
        if alpha_j is None:  # the JAX decoder seeds on the host
            seed = np.full(s, -np.inf, np.float32)
            seed[comp.lowers] = lb[0, comp.lowers] + coefs[6].numpy()[comp.lowers]
            alpha_j = jnp.asarray(seed)
        alpha_j, bp_j = _stream_chunk(alpha_j, jtrans, jnp.asarray(lb), t, c)
        alpha_t, bp_t = k4_chunk(alpha_t, np.array([t]), np.array([c]),
                                 torch.as_tensor(lb)[None], trans, coefs)
        np.testing.assert_array_equal(alpha_t[0].numpy(), np.asarray(alpha_j))
        np.testing.assert_array_equal(np.signbit(alpha_t[0].numpy()),
                                      np.signbit(np.asarray(alpha_j)))
        np.testing.assert_array_equal(bp_t[0, :c].numpy(), np.asarray(bp_j)[:c])
        t += c


def test_streaming_reset_from_models_and_unported_options():
    models = _models(seed=3)
    stream = StreamingComposite.from_models({m.label: m for m in models}, penalty=-4.0,
                                            chunk_size=8, device="cpu")
    assert stream.composite.labels == ["A", "B", "S"]
    feats = (np.random.default_rng(2).normal(size=(9, 4)) * 2).astype(np.float32)
    stream.feed(feats)
    first = stream.finalize()
    stream.reset()
    assert stream.partial_labels() == ""
    stream.feed(feats[:0])
    stream.feed(feats)
    again = stream.finalize()
    assert again[0] == first[0]
    np.testing.assert_array_equal(again[1], first[1])
    # GMM models stream (they raised before GMMs were ported): K = 1 GMMs
    # give the single-Gaussian stream's result, through gmm_params and
    # through from_models.
    from cs304_tpu_torch.models.gmm_hmm import GMMWordHMM
    from cs304_tpu_torch.ops.gaussian import make_gmm_params

    gmm = [GMMWordHMM(m.label, m.means[:, None], m.covariances[:, None],
                      np.ones((m.num_states, 1), np.float32), m.log_a) for m in models]
    c = stream.composite
    params = make_gmm_params(c.means[:, None], c.covariances[:, None],
                             np.ones((c.num_states, 1), np.float32), device="cpu")
    for gstream in (StreamingComposite(c, chunk_size=8, gmm_params=params, device="cpu"),
                    StreamingComposite.from_models(gmm, penalty=-4.0, chunk_size=8,
                                                   device="cpu")):
        gstream.feed(feats)
        score, path = gstream.finalize()
        np.testing.assert_array_equal(path, first[1])
        np.testing.assert_allclose(score, first[0], rtol=1e-5)
