"""Path -> word-sequence compaction on the paths' device.

A word is emitted at the first frame, at any frame whose state belongs to a
different word than the previous frame's, and at an exit->entry hop back
into the SAME word (a repeated word); frames past ``length`` and the silence
word never emit. This mirrors CompositeHMM.path_to_labels, but reads back
only (B, max_words) word ids and (B,) counts instead of (B, T) paths.

Every lookup is an integer compare or a masked integer reduction. A float
matmul here would be exact only while ids and state indices stay below the
matmul's mantissa (TF32 keeps 11 bits), and states reach 5003 at a
1000-word vocabulary.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ids_to_strings", "words_from_path", "words_from_paths"]


def words_from_paths(paths, lengths, word_of_state, lowers, uppers,
                     silence_word: int, max_words: int = 32):
    """(B, T) int paths + (B,) lengths -> ((B, max_words) int32 ids padded
    with -1, (B,) int32 true counts). A count above max_words means the
    buffer truncated (ids_to_strings raises on it). word_of_state is
    accepted for the reference signature; the word of a state is the rank
    query #{w : lowers[w] <= state} - 1 (states are stacked word by word).
    silence_word -1 keeps silence."""
    del word_of_state
    paths = torch.as_tensor(paths).to(torch.int32)
    dev = paths.device
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    lowers = torch.as_tensor(lowers, device=dev).to(torch.int32)
    uppers = torch.as_tensor(uppers, device=dev).to(torch.int32)
    b, t = paths.shape
    w_num = lowers.shape[0]
    idx = torch.arange(t, device=dev)
    prev = torch.cat([paths[:, :1], paths[:, :-1]], dim=1)

    def word_of(p):
        return torch.sum(p[:, :, None] >= lowers, dim=-1, dtype=torch.int32) - 1

    word = word_of(paths)
    prev_word = word_of(prev)
    woh = word[:, :, None] == torch.arange(w_num, device=dev, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    up_of = torch.sum(torch.where(woh, uppers, zero), dim=-1, dtype=torch.int32)
    lo_of = torch.sum(torch.where(woh, lowers, zero), dim=-1, dtype=torch.int32)
    first = idx[None, :] == 0
    new_point = first | (paths != prev)
    reentry = (prev == up_of) & (paths == lo_of)
    emit = new_point & (first | (word != prev_word) | reentry)
    emit = emit & (idx[None, :] < lengths[:, None]) & (word != silence_word)
    pos = torch.cumsum(emit.to(torch.int32), dim=1) - 1
    n = torch.sum(emit, dim=1, dtype=torch.int32)
    slots = torch.arange(max_words, device=dev, dtype=torch.int32)
    slotoh = (pos[:, :, None] == slots) & emit[:, :, None]
    ids_i = torch.sum(torch.where(slotoh, word[:, :, None], zero), dim=1,
                      dtype=torch.int32)
    minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
    ids = torch.where(slots[None, :] < n[:, None], ids_i, minus1)
    return ids, n


def words_from_path(path, length, word_of_state, lowers, uppers,
                    silence_word: int, max_words: int = 32):
    """One (T,) path -> ((max_words,) ids, count)."""
    path = torch.as_tensor(path)
    ids, n = words_from_paths(
        path[None], torch.as_tensor([int(length)], device=path.device),
        word_of_state, lowers, uppers, silence_word, max_words,
    )
    return ids[0], n[0]


def ids_to_strings(ids, counts, labels) -> list:
    """(B, W) ids + (B,) counts -> list of label strings. A count above W
    (a truncated buffer) raises ValueError."""
    ids = np.asarray(ids)
    counts = np.asarray(counts)
    w = ids.shape[1]
    out = []
    for row, n in zip(ids, counts):
        if n > w:
            raise ValueError(
                f"word buffer truncated: {n} words emitted, max_words={w}"
            )
        out.append("".join(labels[i] for i in row[: int(n)]))
    return out
