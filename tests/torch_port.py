"""Shared fixture of the ``tests/test_torch_*.py`` files of the PyTorch port."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel workers on a few cores: keep
    PyTorch's CPU kernels to one thread so these small tests do not starve
    the timing-sensitive multi-process tests running beside them."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
