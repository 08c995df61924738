"""Shared fixture of the port's CPU tests (tests/test_torch_*.py)."""

import dataclasses

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


def port_config(cfg):
    """The port's CodecConfig with the fields of the reference's `cfg`."""
    from screenpressor_tpu_torch.config import CodecConfig

    return CodecConfig(**dataclasses.asdict(cfg))
