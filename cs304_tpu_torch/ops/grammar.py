"""Grammar-constrained composite Viterbi: decode under a word-level DFA.

The port of the JAX package's ops/grammar.py. The composite trellis is
composed with a deterministic automaton over the vocabulary (digit patterns
with per-position alphabets, finite transcript sets, count ranges): the
trellis state is (G, S), grammar plane x composite state; a step is the
stay move of ops/viterbi_counted.py inside each plane and a cross move that
routes each plane's best word exit through the DFA's transition table.
Silence is grammar-transparent (its column is the identity). Entry seeding,
the exits-over-self-loop tie order and the backtrace quirk follow
ops/viterbi.py; every argmax is a first max. WordDFA and its builders are
NumPy, copied. On a CUDA log_b the trellis is one launch of the PLANES
kernel (ops/cuda/trellis_constrained.planes_decode), which walks its own
path (past its team branches: and one of K2-bt); its plain version,
viterbi_composite_grammar_batch_plain, advances a batch (B, G, S) by a
Python loop over T, for the CPU and the tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from .cuda.trellis_constrained import planes_decode
from .viterbi import NEG
from .viterbi_counted import _stay_matrix, _topology, packed_backtrace


@dataclass(frozen=True)
class WordDFA:
    """Deterministic word automaton over a composite's label list.

    next_state[g, w] is the plane reached by emitting word w (the index into
    ``labels``) from plane g, or -1 when w is not allowed there. Decoding
    starts in plane 0 and must END in an accepting plane. The silence label's
    column (if present) must be the identity — build through the helpers and
    it is enforced automatically.
    """

    next_state: np.ndarray  # (G, W) int32, -1 = disallowed
    accept: np.ndarray  # (G,) bool
    labels: List[str]  # composite word order (the decoder's labels)

    def __post_init__(self):
        ns = np.asarray(self.next_state)
        if ns.ndim != 2 or ns.shape[1] != len(self.labels):
            raise ValueError(
                f"next_state {ns.shape} does not match {len(self.labels)} labels"
            )
        if ns.max(initial=-1) >= ns.shape[0]:
            raise ValueError("next_state points past the last plane")
        if not np.asarray(self.accept).any():
            raise ValueError("grammar accepts nothing (no accepting plane)")

    @property
    def num_planes(self) -> int:
        return self.next_state.shape[0]

    # -- builders -------------------------------------------------------------
    @classmethod
    def from_positions(
        cls,
        position_sets: Sequence[Sequence[str]],
        labels: Sequence[str],
        silence: str = "S",
    ) -> "WordDFA":
        """Fixed-length pattern: position i must be one of position_sets[i].

        E.g. a 3-digit code whose first digit is 1-3:
        from_positions([("1","2","3"), all_digits, all_digits], labels).
        """
        labels = list(labels)
        n = len(position_sets)
        if n == 0:
            raise ValueError("empty pattern")
        g = n + 1
        next_state = np.full((g, len(labels)), -1, np.int32)
        for i, words in enumerate(position_sets):
            for word in words:
                if word == silence:
                    raise ValueError("silence cannot be a pattern position")
                next_state[i, _windex(labels, word)] = i + 1
        accept = np.zeros(g, bool)
        accept[n] = True
        return cls(_silence_identity(next_state, labels, silence), accept, labels)

    @classmethod
    def from_strings(
        cls, strings: Sequence[str], labels: Sequence[str], silence: str = "S"
    ) -> "WordDFA":
        """Finite transcript set as a trie DFA (command-menu decoding)."""
        labels = list(labels)
        strings = list(strings)
        if not strings:
            raise ValueError("empty string set")
        # Trie: node 0 is the root; nodes created on demand.
        next_state = [np.full(len(labels), -1, np.int32)]
        accept = [False]
        for text in strings:
            if not text:
                raise ValueError("empty transcript in the string set")
            node = 0
            for word in text:
                w = _windex(labels, word)
                if word == silence:
                    raise ValueError("silence cannot appear in a transcript")
                if next_state[node][w] < 0:
                    next_state[node][w] = len(next_state)
                    next_state.append(np.full(len(labels), -1, np.int32))
                    accept.append(False)
                node = int(next_state[node][w])
            accept[node] = True
        ns = np.stack(next_state)
        return cls(
            _silence_identity(ns, labels, silence),
            np.asarray(accept, bool),
            labels,
        )

    @classmethod
    def exact_count(
        cls,
        n_words: int,
        labels: Sequence[str],
        n_words_min: int | None = None,
        silence: str = "S",
    ) -> "WordDFA":
        """The word-count constraint as a grammar: between n_words_min
        (default n_words) and n_words words, any vocabulary order — the DFA
        equivalent of ops/viterbi_counted.py."""
        labels = list(labels)
        g = n_words + 1
        next_state = np.full((g, len(labels)), -1, np.int32)
        for plane in range(n_words):
            for w, label in enumerate(labels):
                if label != silence:
                    next_state[plane, w] = plane + 1
        accept = np.zeros(g, bool)
        lo = n_words if n_words_min is None else n_words_min
        accept[lo : n_words + 1] = True
        return cls(_silence_identity(next_state, labels, silence), accept, labels)


def _windex(labels: List[str], word: str) -> int:
    try:
        return labels.index(word)
    except ValueError:
        raise ValueError(
            f"grammar word {word!r} is not in the vocabulary {labels}"
        ) from None


def _silence_identity(next_state: np.ndarray, labels, silence: str) -> np.ndarray:
    if silence in labels:
        next_state = next_state.copy()
        next_state[:, labels.index(silence)] = np.arange(
            next_state.shape[0], dtype=np.int32
        )
    return next_state


def viterbi_composite_grammar_batch(
    log_b, log_a, lower_of_state, is_entry, is_exit, word_of_state,
    next_state, accept, penalty, lengths, quirk_backtrace: bool = True,
):
    """Best paths whose emitted word sequence the DFA accepts: log_b
    (B, T, S) float32, word_of_state (S,), next_state (G, W) int (-1 =
    disallowed; the silence column the identity), accept (G,) bool,
    lengths (B,) -> (scores (B,), paths (B, T) int32); a score is -inf where
    no accepted path exists in the utterance's frames. A CUDA log_b runs
    the PLANES kernel, bitwise the plain version in scores and in the paths
    of every row with a finite score (ROADMAP W3); a CPU log_b the plain
    version."""
    if not log_b.is_cuda:
        return viterbi_composite_grammar_batch_plain(
            log_b, log_a, lower_of_state, is_entry, is_exit, word_of_state, next_state,
            accept, penalty, lengths, quirk_backtrace)
    return planes_decode(log_b, log_a, lower_of_state, is_entry, is_exit, word_of_state,
                         next_state, accept, penalty, lengths, quirk_backtrace)


def viterbi_composite_grammar_batch_plain(
    log_b, log_a, lower_of_state, is_entry, is_exit, word_of_state,
    next_state, accept, penalty, lengths, quirk_backtrace: bool = True,
):
    """viterbi_composite_grammar_batch's plain version, on log_b's device:
    the (B, G, S) trellis advanced by a Python loop over T."""
    b, t_total, s = log_b.shape
    dev = log_b.device
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    log_a, entry, exit_, diag_init = _topology(log_b, log_a, is_entry, is_exit)
    stay = _stay_matrix(log_a, lower_of_state, entry)
    penalty = torch.as_tensor(penalty, dtype=torch.float32, device=dev)
    next_state = torch.as_tensor(np.asarray(next_state), device=dev).to(torch.int64)
    accept = torch.as_tensor(np.asarray(accept), device=dev).to(torch.bool)
    entry_word = torch.as_tensor(np.asarray(word_of_state), device=dev).to(torch.int64)
    g = next_state.shape[0]
    gidx = torch.arange(g, device=dev)
    # route[src_g, dst_g, w]: emitting w from src_g lands in dst_g.
    route = next_state[:, None, :] == gidx[None, :, None]            # (G, G, W)
    # Starting inside word w at t = 0 emits w once from plane 0.
    seed_plane = next_state[0][entry_word][None, :] == gidx[:, None]  # (G, S)
    alpha = torch.where(entry[None, :] & seed_plane,
                        (log_b[:, 0] + diag_init)[:, None, :], NEG)  # (B, G, S)
    stay_plane = gidx[:, None].expand(g, s)
    bps = torch.empty((b, t_total, g * s), dtype=torch.int32, device=dev)
    bps[:, 0] = -1
    for t in range(1, t_total):
        stay_val, stay_bp = torch.max(alpha[:, :, :, None] + stay, dim=2)
        be, be_idx = torch.where(exit_, alpha, NEG).max(dim=2)        # (B, G)
        routed = torch.where(route, be[:, :, None, None], NEG)         # (B, G, G, W)
        src_best, src_plane = routed.max(dim=1)                        # (B, G_dst, W)
        cross_val = torch.where(entry, src_best[:, :, entry_word] + penalty, NEG)
        cross_plane = src_plane[:, :, entry_word]                      # (B, G, S)
        cross_state = be_idx.gather(1, cross_plane.reshape(b, -1)).reshape(b, g, s)
        # Exits win exact ties against the entry self-loop.
        use_cross = cross_val >= stay_val
        new_alpha = torch.maximum(stay_val, cross_val) + log_b[:, t, None, :]
        bp_state = torch.where(use_cross, cross_state, stay_bp)
        bp_plane = torch.where(use_cross, cross_plane, stay_plane)
        bps[:, t] = (bp_plane * s + bp_state).reshape(b, -1).to(torch.int32)
        alpha = torch.where((t < lengths)[:, None, None], new_alpha, alpha)

    final = torch.where(accept[:, None] & exit_[None, :], alpha, NEG).reshape(b, -1)
    scores, flat = final.max(dim=1)
    paths = packed_backtrace(bps, flat, lengths, quirk_backtrace) % s
    return scores, paths.to(torch.int32)


def viterbi_composite_grammar(
    log_b, log_a, lower_of_state, is_entry, is_exit, word_of_state,
    next_state, accept, penalty, length=None, quirk_backtrace: bool = True,
):
    """One utterance: log_b (T, S) -> (score, path (T,) int32) of
    viterbi_composite_grammar_batch on a batch of one."""
    length = log_b.shape[0] if length is None else int(length)
    scores, paths = viterbi_composite_grammar_batch(
        log_b[None], log_a, lower_of_state, is_entry, is_exit, word_of_state,
        next_state, accept, penalty, [length], quirk_backtrace)
    return scores[0], paths[0]
