"""Shared fixture of the PyTorch port's CPU tests."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests are thousands of small CPU ops. With one thread each they
    keep their pace beside parallel test workers; eight OpenMP threads per
    worker on shared cores spend their time waiting for one another.
    A test module takes it with ``from torch_threads import
    one_torch_thread``."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
