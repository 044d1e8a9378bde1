"""tests/torch_poison.py on the CPU: inside the window torch.empty,
torch.empty_like and Tensor.new_empty hand back memory filled with the
pattern, the three patterns differ from each other in every dtype the
wrappers allocate, the allocators come back after the window, and a
function that skips one cell of its torch.empty output fails the
comparison: the two kernel poisons disagree there, and each differs from
the plain version's cell whatever that cell holds."""
import pytest
import torch

from torch_poison import (
    KERNEL_POISONS,
    PLAIN_POISON,
    bits,
    differing_cells,
    kernel_runs,
    plain_run,
    poison_value,
    poisoned,
)

PATTERNS = (*KERNEL_POISONS, PLAIN_POISON)


def _skips_cell_0(n, fill0=None):
    """An output of n cells written from torch.empty, cell 0 left alone
    (fill0: the value a correct version writes there)."""
    out = torch.empty((n,), dtype=torch.float32)
    out[1:] = torch.arange(1, n, dtype=torch.float32)
    if fill0 is not None:
        out[0] = fill0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint8, torch.int8,
                                   torch.int16, torch.int64, torch.bfloat16])
def test_the_patterns_differ_in_every_dtype(dtype):
    cells = [torch.full((1,), poison_value(dtype, p), dtype=dtype) for p in PATTERNS]
    for i in range(len(cells)):
        for j in range(i + 1, len(cells)):
            assert not torch.equal(bits(cells[i]), bits(cells[j])), (PATTERNS[i], PATTERNS[j])


@pytest.mark.parametrize("pattern", PATTERNS)
def test_allocations_in_the_window_hold_the_pattern(pattern):
    empty = torch.empty
    with poisoned(pattern):
        made = [torch.empty((3, 4)), torch.empty(5, dtype=torch.int32),
                torch.empty_like(torch.zeros(2, dtype=torch.uint8)),
                torch.zeros(2).new_empty((6,)), torch.empty(())]
    assert torch.empty is empty
    for t in made:
        want = torch.full(t.shape, poison_value(t.dtype, pattern), dtype=t.dtype)
        assert torch.equal(bits(t), bits(want)), (pattern, t.dtype)


def test_the_allocators_come_back_after_an_error():
    fns = (torch.empty, torch.empty_like, torch.Tensor.new_empty)
    with pytest.raises(RuntimeError):
        with poisoned("nan"):
            raise RuntimeError("inside the window")
    assert (torch.empty, torch.empty_like, torch.Tensor.new_empty) == fns
    with pytest.raises(ValueError):
        with poisoned("no-such-pattern"):
            pass


def test_a_skipped_cell_fails_the_comparison():
    """The poison bites: a function that skips cell 0 of its torch.empty
    output gives runs that differ there under the two kernel poisons
    (kernel_runs raises), and each run differs from the plain version's cell
    even where the correct value is NaN, which the NaN poison alone would
    pass under a NaN-equal comparison."""
    with pytest.raises(AssertionError, match="1 cells differ"):
        kernel_runs(_skips_cell_0, 5)
    for fill0 in (0.0, float("nan")):
        want = plain_run(_skips_cell_0, 5, fill0)
        caught = []
        for pattern in KERNEL_POISONS:
            with poisoned(pattern):
                got = _skips_cell_0(5)
            caught.append(not torch.equal(bits(got), bits(want)))
            assert differing_cells(got, want) <= 1
        assert any(caught), fill0
    # A version that writes every cell passes, and its runs agree.
    runs = kernel_runs(_skips_cell_0, 5, 0.0)
    assert torch.equal(runs[0], torch.arange(5, dtype=torch.float32))


def test_a_cell_both_versions_skip_differs():
    want = plain_run(_skips_cell_0, 4)
    for pattern in KERNEL_POISONS:
        with poisoned(pattern):
            got = _skips_cell_0(4)
        assert differing_cells(got, want) == 1


def test_differing_cells_walks_results():
    a = (torch.tensor([1.0, -0.0]), [torch.tensor([1, 2], dtype=torch.int32)], 3)
    b = (torch.tensor([1.0, 0.0]), [torch.tensor([1, 5], dtype=torch.int32)], 4)
    assert differing_cells(a, a) == 0
    assert differing_cells(a, b) == 3  # the sign of zero, one integer, the scalar
