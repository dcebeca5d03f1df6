"""One torch thread in every benchmark test: the tensors are small, and
with several test workers on one machine torch's intra-op thread pools
only fight each other for the cores."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
