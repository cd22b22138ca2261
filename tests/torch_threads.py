"""The port's CPU test files share one fixture: one intra-op torch thread.

Under the suite's six workers, torch's default of one thread per core
oversubscribes the cores and the port's small CPU shapes run up to 10x
slower. A test file takes the fixture by importing it (pytest picks up an
autouse fixture that a test module imports):

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the file's tests; the old count after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
