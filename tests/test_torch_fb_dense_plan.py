"""FBD's plan (ops/cuda/forward_backward.py:fb_dense_plan): which build of
csrc/forward_backward.cu runs S states. The library's own plan is held to
it on the card (tests/test_torch_cuda_kernels.py)."""
import pytest

from cs304_tpu_torch.ops.cuda import forward_backward as fbd

PLAN = {1: "w8", 2: "w8", 5: "w8", 8: "w8", 9: "w16", 16: "w16", 17: "w32", 32: "w32",
        33: "b64", 59: "b64", 64: "b64", 65: "b128", 128: "b128"}


@pytest.mark.parametrize("s", sorted(PLAN))
def test_plan_picks_the_narrowest_build(s):
    build = fbd.fb_dense_plan(s)
    assert build == PLAN[s]
    most = fbd.FBD_BUILDS[build][0]
    assert most >= s
    # no build the plan takes is narrower and still holds S
    planned = {fbd.fb_dense_plan(k) for k in range(1, fbd.MAX_FB_DENSE_STATES + 1)}
    assert not [b for b in planned if s <= fbd.FBD_BUILDS[b][0] < most]


def test_plan_covers_every_state_count_and_no_more():
    builds = [fbd.fb_dense_plan(s) for s in range(1, fbd.MAX_FB_DENSE_STATES + 1)]
    assert builds == sorted(builds, key=lambda b: fbd.FBD_BUILDS[b][0])
    for s in (0, fbd.MAX_FB_DENSE_STATES + 1):
        with pytest.raises(ValueError, match="states"):
            fbd.fb_dense_plan(s)


@pytest.mark.parametrize("name", sorted(fbd.FBD_BUILDS))
def test_build_shapes_fill_their_threads(name):
    """A build's threads hold its states, a thread a state, and its
    sequences a block fill one warp (warp builds) or its block."""
    most, threads, seqs = fbd.FBD_BUILDS[name]
    assert threads == most
    assert threads * seqs == (32 if name.startswith("w") else most)
