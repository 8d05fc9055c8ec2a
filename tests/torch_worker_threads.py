"""The port's tests take their worker's share of the CPUs.

Under pytest-xdist several workers run at once, and each worker's torch
would otherwise start as many intra-op threads as the machine has CPUs:
n workers then run n times as many busy threads as there are CPUs, and
every test waits on the others.  Each ``tests/test_torch_*.py`` module imports
``worker_threads``, an autouse fixture of module scope.  While the
module runs under xdist it sets torch's intra-op threads, and
``OMP_NUM_THREADS`` / ``MKL_NUM_THREADS`` for the processes its tests
start, to ``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` (at least 1),
and puts all three back when the module ends.  Outside xdist it does
nothing.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def worker_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers < 2:
        yield
        return
    share = max(1, (os.cpu_count() or 1) // workers)
    before = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(share))
        mp.setenv("MKL_NUM_THREADS", str(share))
        torch.set_num_threads(share)
        try:
            yield share
        finally:
            torch.set_num_threads(before)
