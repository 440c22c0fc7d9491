"""The port's prefetcher (``datasets/loader.py``) on the CPU: the JAX
package's loader tests (``tests/test_loader_prefetch.py``) against the
port. The stage runs in the prefetch thread, order holds, and a stage
error reaches the consumer after the items before it. The CUDA path (side
stream, pinned uploads) is a ``gpu`` test in ``tests/test_torch_cuda.py``.
"""

import threading

import numpy as np
import pytest
import torch

from v2x_sim_tpu_torch.datasets.loader import device_prefetch, prefetch


def test_prefetch_preserves_order_and_drains():
    src = list(range(17))
    assert list(prefetch(iter(src), depth=3)) == src


@pytest.mark.parametrize("device", [None, "cpu"])
def test_device_prefetch_applies_stage_off_main_thread(device):
    main = threading.get_ident()
    seen_threads = set()

    def stage(x):
        seen_threads.add(threading.get_ident())
        return x * 10

    out = list(device_prefetch(iter(range(8)), stage, depth=2, device=device))
    assert out == [x * 10 for x in range(8)]
    assert main not in seen_threads  # the stage ran in the prefetch thread


@pytest.mark.parametrize("device", [None, "cpu"])
def test_device_prefetch_surfaces_stage_errors(device):
    def stage(x):
        if x == 3:
            raise ValueError("boom at 3")
        return x

    got = []
    with pytest.raises(ValueError, match="boom at 3"):
        for x in device_prefetch(iter(range(6)), stage, depth=2, device=device):
            got.append(x)
    assert got == [0, 1, 2]  # the items before the failure were delivered


def test_device_prefetch_on_the_cpu_passes_host_batches_to_the_stage():
    """Off the card the stage gets each host dict as it is (no upload)."""
    batches = [{"x": np.full(3, i, np.float32)} for i in range(4)]
    out = list(device_prefetch(iter(batches), lambda b: torch.as_tensor(b["x"]).sum(), device="cpu"))
    assert [float(t) for t in out] == [0.0, 3.0, 6.0, 9.0]
