"""Tracing / profiling helpers (SURVEY.md section 5: the reference has none).

Wraps torch.profiler so model runs can emit Chrome traces viewable in
Perfetto or chrome://tracing, plus a simple wall-clock timer for kernel
microbenchmarks; the JAX package's counterpart is
``clima_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .checkpoint import tree_flatten

__all__ = ["trace", "Timer", "time_fn"]


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager profiling the host and, where there is one, the CUDA
    device; on exit it writes a Chrome trace ``trace_<pid>_<ns>.json`` into
    ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer:
    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0


def _sync(out):
    """Wait for the CUDA devices that hold a tensor of ``out`` (a tensor or
    a nested dict / list / tuple); CPU results are ready when returned."""
    leaves, _ = tree_flatten(out)
    for device in {x.device for x in leaves if torch.is_tensor(x) and x.is_cuda}:
        torch.cuda.synchronize(device)


def time_fn(fn, *args, n_iter=10, warmup=1):
    """Steady-state seconds/call of ``fn(*args)``, each call closed by a
    synchronisation of its outputs' CUDA devices."""
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args)
        _sync(out)
    return (time.perf_counter() - t0) / n_iter
