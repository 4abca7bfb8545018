"""One torch thread for a port test module.

The tier-1 suite runs six pytest-xdist workers on eight cores. Each
worker's torch would start eight intra-op threads, and 48 spinning
threads on eight cores slow every parallel torch op of the port's CPU
tests by tens of times: a calibration fit takes 3.2 s alone, over 120 s
beside two more such processes on 8 cores and 4.4 s with one thread, and
the whole tier-1 suite's junit time fell from 7,039 to 1,556 CPU-seconds
with one thread in every port module. A port test module imports
``one_torch_thread``; the autouse fixture runs the module's tests with
one intra-op thread and restores the count after.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
