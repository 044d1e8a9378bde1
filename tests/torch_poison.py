"""Poisoned allocations for the checks that hold a kernel against its plain
version: inside ``poisoned(pattern)``, ``torch.empty``, ``torch.empty_like``
and ``Tensor.new_empty`` return memory already filled with ``pattern``, so a
cell that a kernel (or a plain version) leaves unwritten holds the poison and
not whatever the caching allocator last kept there.

A check calls the kernel's wrapper once under each of ``KERNEL_POISONS``
(``kernel_runs``) and its plain version under ``PLAIN_POISON``
(``plain_run``), which differs from both: a cell the kernel leaves unwritten
then differs under at least one of the two, whatever the plain version holds
there, and a cell both leave unwritten differs as well.

Patterns by dtype (each the same bytes in every cell):

    pattern  float          int16/32/64       uint8 / int8   bool
    "nan"    NaN            -12345            0xFF / -128    True
    "fill"   0x7F7F7F7F...  0x5A5A5A5A...     0xA5           False
    "plain"  0xC3C3C3C3...  0xC3C3C3C3...     0xC3           True

Importable on its own (``--noconftest``); the card machine has no JAX.
"""
import contextlib

import numpy as np
import torch

KERNEL_POISONS = ("nan", "fill")
PLAIN_POISON = "plain"
_BYTES = {"fill": (0x7F, 0x5A, 0xA5), "plain": (0xC3, 0xC3, 0xC3)}


def poison_value(dtype, pattern):
    """The scalar every cell of a ``dtype`` tensor holds under ``pattern``."""
    if dtype == torch.bool:
        return pattern != "fill"
    one_byte = dtype.itemsize == 1
    if pattern == "nan":
        if dtype.is_floating_point:
            return float("nan")
        return (0xFF if dtype == torch.uint8 else -128) if one_byte else -12345
    if pattern not in _BYTES:
        raise ValueError(f"unknown poison {pattern!r}")
    f_byte, i_byte, b_byte = _BYTES[pattern]
    byte = f_byte if dtype.is_floating_point else b_byte if one_byte else i_byte
    cell = torch.full((dtype.itemsize,), byte, dtype=torch.uint8).view(dtype)
    return cell[0].item()


def poison_(t, pattern):
    """Fill ``t`` in place with ``pattern``'s cells; returns ``t``."""
    if t.numel():
        t.fill_(poison_value(t.dtype, pattern))
    return t


@contextlib.contextmanager
def poisoned(pattern):
    """``torch.empty``, ``torch.empty_like`` and ``Tensor.new_empty`` filled
    with ``pattern`` for the window (on the current stream, before the
    caller can launch into them)."""
    poison_value(torch.float32, pattern)  # refuse an unknown name up front
    empty, empty_like, new_empty = torch.empty, torch.empty_like, torch.Tensor.new_empty
    torch.empty = lambda *a, **k: poison_(empty(*a, **k), pattern)
    torch.empty_like = lambda *a, **k: poison_(empty_like(*a, **k), pattern)
    torch.Tensor.new_empty = lambda self, *a, **k: poison_(new_empty(self, *a, **k), pattern)
    try:
        yield
    finally:
        torch.empty, torch.empty_like, torch.Tensor.new_empty = empty, empty_like, new_empty


def bits(t):
    """``t``'s cells as integers of its width (floats: their bit patterns,
    so NaN equals NaN of the same bits and -0.0 differs from +0.0)."""
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.dtype.itemsize])
    return t


def differing_cells(a, b):
    """Cells whose bits differ between two results of one call (tensors,
    or tuples and lists of them; other values compared with ==)."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        return sum(differing_cells(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        a, b = (torch.from_numpy(np.ascontiguousarray(x)) for x in (a, b))
    if isinstance(a, torch.Tensor):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        return int((bits(a) != bits(b)).sum())
    return int(a != b)


def kernel_runs(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` once under each of KERNEL_POISONS: a list of
    the two results, in that order. Raises AssertionError where their bits
    differ in any cell: a cell the call leaves unwritten holds each run's
    poison."""
    runs = []
    for pattern in KERNEL_POISONS:
        with poisoned(pattern):
            runs.append(fn(*args, **kwargs))
    n = differing_cells(*runs)
    assert n == 0, f"{getattr(fn, '__name__', fn)}: {n} cells differ between the two poisons"
    return runs


def plain_run(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under PLAIN_POISON."""
    with poisoned(PLAIN_POISON):
        return fn(*args, **kwargs)
