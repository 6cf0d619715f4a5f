"""Replaying one step of a column march as a CUDA graph.

A column march in PyTorch is a sequential loop of small tensor operations
over a batch of columns: the moist-adiabat march's twin
(``adiabat.profile._march_torch``) about 4700 per substep, 28000 per interval
of the profile grid. Run eagerly on the card, each operation is a kernel
launch paid on the host, so a march is bound by launch latency.
:func:`graphed` captures one step of such a loop (one interval) into a CUDA
graph once and replays it for the other steps, so the host launches one graph
per interval instead of every kernel. This is the counterpart of the
``jax.jit`` the JAX package puts around the same code. The RC march
(``adiabat.profile_rc``) and the altitude solve (``adiabat.altitude``) run
this way on the card; the moist-adiabat march itself is one hand-written
kernel there (``ops.march_cuda``), and its twin replays a graph.

Capture needs a step free of host synchronisation, which the march is (no
``.item()``, no branch on values). A failed capture raises; nothing falls
back to eager execution.
"""

from __future__ import annotations

import time

import torch

from ..utils.profiling import span

__all__ = ["graphed", "CAPTURE_SECONDS", "CAPTURES", "WARMUP_SECONDS", "REPLAYS"]

# function name -> seconds spent capturing graphs of it (warm-up run included)
CAPTURE_SECONDS = {}
# function name -> graphs captured of it
CAPTURES = {}
# function name -> seconds of the eager warm-up runs before its captures
WARMUP_SECONDS = {}
# function name -> replays of its graphs
REPLAYS = {}


def graphed(fn, *inputs):
    """Capture ``fn(*inputs)`` (CUDA tensors in, a tuple of CUDA tensors out).

    Returns (replay, first): ``first`` is fn's result on ``inputs`` (from the
    warm-up run that precedes capture); ``replay(*args)`` copies ``args``
    into the captured input buffers, replays the graph and returns the
    captured output buffers, which the next replay overwrites. Tensors that
    ``fn`` closes over must stay alive as long as ``replay``. The warm-up
    run is the span ``ops.cuda_graph.warmup``, on the side stream it runs on.
    """
    t0 = time.perf_counter()
    name = getattr(fn, "func", fn).__name__  # a functools.partial names its function
    static = [x.clone() for x in inputs]
    side = torch.cuda.Stream(device=static[0].device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), span("ops.cuda_graph.warmup"):
        t1 = time.perf_counter()
        first = tuple(t.clone() for t in fn(*static))
        t2 = time.perf_counter()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = fn(*static)
    CAPTURE_SECONDS[name] = CAPTURE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
    WARMUP_SECONDS[name] = WARMUP_SECONDS.get(name, 0.0) + t2 - t1
    CAPTURES[name] = CAPTURES.get(name, 0) + 1

    def replay(*args):
        for buf, a in zip(static, args):
            buf.copy_(a)
        graph.replay()
        REPLAYS[name] = REPLAYS.get(name, 0) + 1
        return outputs

    return replay, first
