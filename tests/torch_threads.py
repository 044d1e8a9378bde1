"""The port test modules' thread pin: import ``one_torch_thread`` into a
test module (an autouse module fixture)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a port module runs: its steps are loops of
    small ops, and the suite's workers share the host's cores, where every
    worker's idle OpenMP threads contend for them (measured: six such files
    in parallel 214 s with the default threads, 31 s with one). Restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
