"""A module-scoped fixture for the port's smoke-size serving tests.

Their tensors are a few kilobytes, so torch's intra-op thread pool buys
them nothing; with several pytest workers on one host its threads
oversubscribe the cores and multiply each test's time. Import
``one_intra_op_thread`` into a test module to run that module's tests on
one intra-op thread; the previous count comes back at the module's end.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
