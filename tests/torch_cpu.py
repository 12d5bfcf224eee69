"""The CPU thread count of the port's tests, set in one place.

Every ``tests/test_torch_*.py`` that runs torch on the CPU imports
:func:`torch_threads` (an autouse fixture of module scope). The suite runs
six workers on the machine's cores: at torch's default of a thread per core
each op of the port's many small ones wakes a pool that the six workers
share, and the files ran several times slower than on one or two threads;
of those, one ran the whole suite faster. A test that holds two runs bit
for bit runs both under this one count, so both sum in one order.
"""

import pytest
import torch

THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Torch on :data:`THREADS` intra-op threads while the module runs, then
    the caller's count again."""
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(prev)
