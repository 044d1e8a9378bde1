"""The port's on-device word compaction (cs304_tpu_torch.ops.words) against
the JAX package's words_from_paths and the host walk path_to_labels,
including a 1000-word (S=5003) composite: ids and state indices past 2048
must survive (integer ops only, never float matmuls)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs304_tpu.ops.words import words_from_paths as j_words
from cs304_tpu_torch.models.hmm import (
    WordHMM,
    flagship_composite,
    stack_word_models,
    uniform_forward_log_a,
)
from cs304_tpu_torch.ops.words import ids_to_strings, words_from_path, words_from_paths


def _large_composite(num_words=1000):
    """1000 five-state words + a 3-state silence: S = 5003."""
    models = [
        WordHMM(label=f"w{i:03d} ", means=np.zeros((5, 1), np.float32),
                covariances=np.ones((5, 1, 1), np.float32),
                log_a=uniform_forward_log_a(5))
        for i in range(num_words)
    ]
    models.append(WordHMM(label="S", means=np.zeros((3, 1), np.float32),
                          covariances=np.ones((3, 1, 1), np.float32),
                          log_a=uniform_forward_log_a(3)))
    return stack_word_models(models)


def _random_paths(rng, comp, b, t, jumpy):
    if jumpy:
        paths = rng.integers(0, comp.num_states, (b, t))
    else:  # word-structured: walk inside words, hop to entries or re-enter
        paths = np.zeros((b, t), np.int64)
        for i in range(b):
            w = int(rng.integers(len(comp.lowers)))
            st = comp.lowers[w]
            for k in range(t):
                paths[i, k] = st
                r = rng.random()
                if r < 0.2 and st < comp.uppers[w]:
                    st += 1
                elif r < 0.3 and st == comp.uppers[w]:
                    w = w if rng.random() < 0.3 else int(rng.integers(len(comp.lowers)))
                    st = comp.lowers[w]
    reps = rng.integers(1, 4, (b, t))
    return np.stack([np.repeat(p, r)[:t] for p, r in zip(paths, reps)]).astype(np.int32)


def _compare(comp, paths, lengths, skip_silence, max_words=64):
    sil = comp.labels.index("S") if (skip_silence and "S" in comp.labels) else -1
    args = (comp.word_of_state, comp.lowers, comp.uppers)
    ids_t, n_t = words_from_paths(torch.as_tensor(paths), torch.as_tensor(lengths),
                                  *args, sil, max_words=max_words)
    ids_j, n_j = j_words(jnp.asarray(paths), jnp.asarray(lengths),
                         *(jnp.asarray(a) for a in args), sil, max_words=max_words)
    assert ids_t.dtype == torch.int32 and n_t.dtype == torch.int32
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    got = ids_to_strings(ids_t.numpy(), n_t.numpy(), comp.labels)
    host = ["".join(comp.path_to_labels(p[:n], skip_silence))
            for p, n in zip(paths, lengths)]
    assert got == host


@pytest.mark.parametrize("skip_silence", [True, False])
@pytest.mark.parametrize("jumpy", [True, False])
def test_fuzz_flagship(skip_silence, jumpy):
    comp = flagship_composite()
    rng = np.random.default_rng(int(skip_silence) * 2 + int(jumpy))
    paths = _random_paths(rng, comp, 24, 45, jumpy)
    lengths = rng.integers(1, 46, 24).astype(np.int32)
    _compare(comp, paths, lengths, skip_silence)


@pytest.mark.parametrize("jumpy", [True, False])
def test_fuzz_1000_words(jumpy):
    comp = _large_composite()
    assert comp.num_states == 5003
    rng = np.random.default_rng(7 + int(jumpy))
    paths = _random_paths(rng, comp, 6, 40, jumpy)
    lengths = rng.integers(1, 41, 6).astype(np.int32)
    _compare(comp, paths, lengths, True)
    # The top of the state space: word ids near 1000, states near 5003.
    tail = np.array([[4995, 4996, 4999, 5000, 5001, 5002, 4995, 4999]], np.int32)
    _compare(comp, tail, np.array([8], np.int32), False)


def test_repeated_word_and_truncation():
    comp = flagship_composite()
    w = 3
    path = np.array([comp.lowers[w], comp.uppers[w], comp.lowers[w],
                     comp.uppers[w]], np.int32)
    ids, n = words_from_path(torch.as_tensor(path), 4, comp.word_of_state,
                             comp.lowers, comp.uppers, -1)
    assert int(n) == 2 and ids_to_strings(ids[None], n[None], comp.labels)[0] == (
        comp.labels[w] * 2)
    alt = np.tile(np.array([comp.lowers[0], comp.lowers[1]], np.int32), 8)
    ids, n = words_from_path(torch.as_tensor(alt), len(alt), comp.word_of_state,
                             comp.lowers, comp.uppers, -1, max_words=4)
    assert int(n) == len(alt)
    with pytest.raises(ValueError, match="truncated"):
        ids_to_strings(ids[None].numpy(), n[None].numpy(), comp.labels)
