"""One torch CPU thread for the port's tests (tests/test_torch_*.py).

torch's CPU kernels start one thread per core by default. The suite runs in
several pytest worker processes at once, and some tests start processes of
their own, so port tests that each use every core oversubscribe the machine:
the same 5-scan odometry run took 0.6 s alone and 10.7 s beside one busy
worker. Every port test file imports `torch_one_thread`, an autouse module
fixture that runs the file's tests on one torch thread and restores the
count after. The spawned ranks of the multi-device tests take one thread
each already (parallel/launch.py's `threads`)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
