"""One torch intra-op thread for a test module.

The port's CPU tests run small worlds (hundreds to a few thousand rows,
D = 16): there torch's intra-op thread pool costs more than it saves on
every small op, and with the suite's six xdist workers the pools
oversubscribe the cores.  A module opts in by importing the fixture::

    from tests._torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Pin torch to one intra-op thread for the module, then restore."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
