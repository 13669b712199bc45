"""One torch thread per test process, for the port's CPU tests.

The tier-1 run spreads the tests over several worker processes.  Each
would otherwise start a pool of torch threads as large as the machine, and
the pools together oversubscribe the cores, which slows every torch op many
times over.  A test module opts in by importing the fixture:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
