"""The port's CPU tests run torch and numpy's BLAS on one thread: the autouse
module fixture ``_one_torch_thread`` below, which each ``test_torch_*.py``
file that runs the port on the CPU imports. Tier-1 runs six test workers on
eight cores, and a thread per core in each worker made their thread pools
spin against each other (the port's files ran 3.5 times slower).

    from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)
"""

import contextlib

import pytest
import torch

try:
    import threadpoolctl
except ImportError:  # the GPU machine has none; there torch's pool alone is limited
    threadpoolctl = None


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch and the BLAS on one CPU thread for the module; both restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    blas = threadpoolctl.threadpool_limits(limits=1) if threadpoolctl else contextlib.nullcontext()
    with blas:  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


def test_one_torch_thread_limits_torch_and_the_blas():
    assert torch.get_num_threads() == 1
    assert all(p["num_threads"] == 1 for p in threadpoolctl.threadpool_info())
