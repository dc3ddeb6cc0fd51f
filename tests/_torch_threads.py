"""The fixture that runs a torch test module on one thread.

The tier-1 command runs six test workers on the machine's cores; a module
that imports ``_one_thread`` from here takes one torch thread in each of its
tests, so that it does not oversubscribe the cores the other workers use.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
