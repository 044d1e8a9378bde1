"""The port's isolated-word classifier (models/collection.py) and the banded
word trellis under it (ops/viterbi.viterbi_banded_batch) against the JAX
package, on the CPU.

Tolerances: ModelCollection scores within rtol 1e-4 / atol 1e-3 of JAX's
(the whitening products sum in other orders in XLA and torch; scores are
sums of ~100 log-densities of magnitude ~50), labels equal. The word
trellis's card path is K3 on the band's diagonals: here its plain version
(banded_sentence_forward + backtrace_batch, which the kernel is bitwise on
the card) is held bitwise against viterbi_banded_batch_plain in scores and
in the paths of every finite row, and the plain word trellis bitwise
against JAX's. enrollment_batches yields JAX's groups.
"""
import numpy as np
import pytest
import torch

from cs304_tpu.models.collection import ModelCollection as JCollection
from cs304_tpu.models.hmm import WordHMM as JWordHMM
from cs304_tpu.models.stacking import enrollment_batches as j_enrollment_batches
from cs304_tpu.models.stacking import stack_models as j_stack_models
from cs304_tpu.ops.viterbi import viterbi_banded_batch as j_viterbi_banded_batch
from cs304_tpu_torch.models import ModelCollection, enrollment_batches, flagship_models
from cs304_tpu_torch.models.stacking import stack_models
from cs304_tpu_torch.ops.cuda.trellis_banded import banded_decode, banded_forward
from cs304_tpu_torch.ops.cuda.trellis_scanfree import trellis_backtrace
from cs304_tpu_torch.ops.viterbi import (
    banded_diagonals,
    viterbi_banded_batch,
    viterbi_banded_batch_plain,
)
from test_torch_train_fused import jax_models, make_corpus, make_models


def _digits():
    return [m for m in flagship_models() if m.label != "S"]


def _clips(rng, n, d=39, lo=8, hi=60):
    return [rng.normal(size=(int(rng.integers(lo, hi)), d)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def collections():
    digits = _digits()
    port = ModelCollection.from_models(digits, device="cpu")
    jax = JCollection.from_models([
        JWordHMM(label=m.label, means=m.means, covariances=m.covariances, log_a=m.log_a)
        for m in digits])
    return port, jax


def test_collection_scores_and_labels_match_jax(collections):
    port, jax = collections
    clips = _clips(np.random.default_rng(0), 12)
    np.testing.assert_allclose(port.score_batch(clips), jax.score_batch(clips),
                               rtol=1e-4, atol=1e-3)
    assert port.predict_batch(clips) == jax.predict_batch(clips)
    assert port.predict(clips[3]) == jax.predict(clips[3])
    assert (port.num_models, port.num_states) == (11, 5)


def test_collection_near_model_means_picks_the_model(collections):
    """A clip walked through a model's means state by state classifies as
    that model, as in JAX."""
    port, jax = collections
    rng = np.random.default_rng(1)
    clips = [np.concatenate([m + 0.3 * rng.normal(size=(4, 39)) for m in model.means])
             .astype(np.float32) for model in _digits()]
    assert port.predict_batch(clips) == jax.predict_batch(clips) == port.labels


def test_collection_ties_go_to_the_first_label():
    """Two identical models: every clip scores equal under both, and the
    first label wins (the reference's stable sort)."""
    m = _digits()[0]
    twin = type(m)(label="zz", means=m.means, covariances=m.covariances, log_a=m.log_a)
    port = ModelCollection.from_models([twin, m], device="cpu")
    scores = port.score_batch(_clips(np.random.default_rng(2), 3))
    assert np.array_equal(scores[:, 0], scores[:, 1])
    assert port.predict_batch(_clips(np.random.default_rng(2), 3)) == ["zz"] * 3


def test_collection_rejects_unequal_state_counts():
    with pytest.raises(ValueError, match="state counts"):
        ModelCollection.from_models(flagship_models(), device="cpu")


def _word_problem(rng, b, t, s, per_row):
    log_b = (2 * rng.normal(size=(b, t, s))).astype(np.float32)
    shape = (b, s, s) if per_row else (s, s)
    log_a = np.log(rng.uniform(size=shape)).astype(np.float32)
    log_a[rng.uniform(size=shape) < 0.05] = -np.inf
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[::4] = 0
    lengths[1] = 1
    return log_b, log_a, lengths


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("b,t,s,per_row", [
    (48, 30, 5, True), (9, 1, 59, False), (17, 70, 59, False), (6, 12, 1, True),
    (6, 12, 2, True), (20, 15, 3, False),
])
def test_word_trellis_kernel_spec_is_the_plain_trellis(b, t, s, per_row, quirk):
    """What the card runs (the sentence trellis on banded_diagonals, final
    state S-1: the decode mode with the quirk, the backpointer mode + K2-bt
    without) equals viterbi_banded_batch_plain: scores on every row, paths
    on every finite row; the plain word trellis is JAX's, bitwise."""
    rng = np.random.default_rng(b * 100 + s)
    log_b, log_a, lengths = _word_problem(rng, b, t, s, per_row)
    lb, la, ln = (torch.as_tensor(x) for x in (log_b, log_a, lengths))
    want_s, want_p = viterbi_banded_batch_plain(lb, la, ln, quirk)
    c0, c1, c2 = banded_diagonals(la, b)
    final = torch.full((b,), s - 1, dtype=torch.int32)
    if quirk:
        got_s, got_p = banded_decode(lb, c0, c1, c2, ln, final)
    else:
        alpha, bp = banded_forward(lb, c0, c1, c2, ln)
        got_s, got_p = alpha[:, s - 1], trellis_backtrace(bp, final, ln, quirk=False)
    assert torch.equal(got_s, want_s)
    finite = torch.isfinite(want_s)
    assert torch.equal(got_p[finite], want_p[finite])
    # The dispatcher takes the plain version on CPU tensors.
    for g, w in zip(viterbi_banded_batch(lb, la, ln, quirk), (want_s, want_p)):
        assert torch.equal(g, w)
    if per_row:  # JAX's word trellis takes one log_a: a row at a time
        rows = [j_viterbi_banded_batch(log_b[i:i + 1], log_a[i], lengths[i:i + 1],
                                       quirk_backtrace=quirk) for i in range(b)]
        j_s = np.concatenate([np.asarray(r[0]) for r in rows])
        j_p = np.concatenate([np.asarray(r[1]) for r in rows])
    else:
        j_s, j_p = j_viterbi_banded_batch(log_b, log_a, lengths, quirk_backtrace=quirk)
    np.testing.assert_array_equal(want_s.numpy(), np.asarray(j_s))
    fin = finite.numpy()
    np.testing.assert_array_equal(want_p.numpy()[fin], np.asarray(j_p)[fin])


def test_banded_diagonals_are_the_band():
    rng = np.random.default_rng(3)
    log_a = torch.as_tensor(rng.normal(size=(4, 6, 6)).astype(np.float32))
    c0, c1, c2 = banded_diagonals(log_a, 4)
    for j in range(6):
        assert torch.equal(c0[:, j], log_a[:, j, j])
        assert torch.equal(c1[:, j], log_a[:, j - 1, j] if j >= 1
                           else torch.full((4,), -np.inf))
        assert torch.equal(c2[:, j], log_a[:, j - 2, j] if j >= 2
                           else torch.full((4,), -np.inf))
    shared = banded_diagonals(log_a[0], 3)
    assert all(c.shape == (3, 6) and c.is_contiguous() for c in shared)


def test_enrollment_batches_match_jax():
    models = make_models()
    labeled = make_corpus(models, ["12", "3"], 2, seed=4)
    labeled["21"] = []  # an empty group is skipped
    port = list(enrollment_batches(stack_models(models), labeled, True, "exit_only"))
    jax = list(j_enrollment_batches(j_stack_models(jax_models(models)), labeled,
                                    True, "exit_only"))
    assert len(port) == len(jax) == 2
    for (pt, pla, pem, ppad), (jt, jla, jem, jpad) in zip(port, jax):
        np.testing.assert_array_equal(pt.lab_of_state, jt.lab_of_state)
        np.testing.assert_array_equal(pla, jla)
        for a, b in zip(pem, jem):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ppad.data, jpad.data)
        np.testing.assert_array_equal(ppad.lengths, jpad.lengths)
    with pytest.raises(ValueError, match="no enrollment"):
        list(enrollment_batches(stack_models(models), {}, True, "exit_only"))
