"""Shared fixture of the port's CPU tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread while a port test module runs. The plain
    versions of the kernels are loops of many tiny tensor ops, and the test
    suite runs several worker processes side by side: with a pool of one
    thread per core in every worker, those loops measured over ten times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
