"""Torch's CPU threads for the port's tests: the machine's cores shared
among pytest-xdist's workers.

Each worker's torch otherwise runs one OpenMP thread per core, and six
workers' spinning threads on eight cores ran tests/test_torch_{train,
train_modes,assign,late_fuse,model,fusion}.py in 1117 s where two threads
a worker took 75 s. A test module takes the fixture by importing it:

    from tests.torch_threads import torch_threads_per_worker  # noqa: F401
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    """Set torch's intra-op threads to cores // workers for the module,
    and restore them after it."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
