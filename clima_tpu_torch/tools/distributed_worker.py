"""Ranks of a multi-process run of the batched entry points over a ``columns`` mesh.

:func:`start` spawns one process per rank (``torch.multiprocessing``), each
running :func:`run`: it joins the process group
(:func:`~clima_tpu_torch.parallel.initialize_distributed`), takes ``mesh =
make_mesh()`` and runs the calls, each on the whole batch with
``mesh=mesh``; :func:`join` waits for the ranks and returns what each
gathered. A call is a tuple ``(name, model, entry point, args, kwargs)``:
``model`` holds the keywords of :func:`build_model`, which builds the model
from the in-memory template (no files), once per process for calls that
share them.

On a host with several cards, ``torchrun`` and a script that calls
``initialize_distributed()`` and passes ``mesh=make_mesh()`` do the same
without this module.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

__all__ = ["build_model", "run_calls", "run", "start", "join"]


def _kernel_wrappers():
    """The column model's kernels by name: their wrappers, which count launches."""
    from ..ops import rorr_cuda, twostream_cuda

    return {"two_stream_ir_weighted": twostream_cuda.two_stream_ir_weighted_cuda,
            "two_stream_solar_multi_weighted": twostream_cuda.two_stream_solar_multi_weighted_cuda,
            "k_rorr_mix": rorr_cuda.k_rorr_mix_cuda}


def build_model(nz, n_zenith, substeps=None, device=None, **template):
    """An AdiabatClimate, quiet, on ``device`` (None: the rank's card) from
    ``make_template(nz=nz, n_zenith=n_zenith, **template)``."""
    from ..adiabat import AdiabatClimate
    from ..data import make_template

    tpl = make_template(nz=nz, n_zenith=n_zenith, **template)
    c = AdiabatClimate(tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"],
                       device=device, **({} if substeps is None else {"substeps": substeps}))
    c.verbose = False
    return c


def _numpy(out):
    if isinstance(out, dict):
        return {k: _numpy(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return tuple(_numpy(v) for v in out)
    return out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)


def run_calls(calls, mesh):
    """Run ``calls`` with ``mesh`` (None: unsharded). Returns ``{name:
    (outputs as numpy, the entry point's structure), seconds, {kernel:
    launches during the call})}``."""
    models, results = {}, {}
    wrappers = _kernel_wrappers()
    for name, model, fn, args, kwargs in calls:
        key = repr(sorted(model.items()))
        if key not in models:
            models[key] = build_model(**model)
        c = models[key]
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn(c, *args, mesh=mesh, **kwargs)
        if c.device.type == "cuda":
            torch.cuda.synchronize(c.device)
        seconds = time.perf_counter() - t0
        results[name] = (_numpy(out), seconds, {k: w.launches for k, w in wrappers.items()})
    return results


def run(rank, world, backend, coordinator, calls, out_dir, threads=None):
    """One rank: join the group of ``world`` ranks at ``coordinator``
    ("host:port"; None: MASTER_ADDR and MASTER_PORT), run ``calls`` on
    ``make_mesh()`` and write their results to ``out_dir``."""
    from ..parallel import initialize_distributed, make_mesh

    if threads:
        torch.set_num_threads(threads)
    initialize_distributed(coordinator, world, rank, backend=backend)
    try:
        results = run_calls(calls, make_mesh())
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        torch.distributed.destroy_process_group()


def start(world, calls, out_dir, backend=None, coordinator=None, threads=None):
    """Spawn the ``world`` ranks of :func:`run`; returns their context for
    :func:`join`."""
    import torch.multiprocessing as mp

    return mp.start_processes(run, args=(world, backend, coordinator, calls, out_dir, threads),
                              nprocs=world, join=False, start_method="spawn")


def join(ctx, out_dir, timeout):
    """Wait up to ``timeout`` seconds for the ranks of :func:`start`, then
    return each rank's :func:`run_calls` results, in rank order. A rank that
    fails raises here (the others are stopped), as does the timeout."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for rank in range(len(ctx.processes)):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
