"""Column throughput against the number of ranks (the port of the JAX
package's ``scripts/scaling.py``).

For each rank count of ``--devices``, spawns that many ranks with
``tools/distributed_worker.py`` (NCCL, one rank per card; gloo on the CPU),
each building its own model (the synthetic template at ``--nz`` layers, one
zenith angle), and runs a workload on the ``columns`` mesh over
``--columns-per-device`` columns a rank: ``toa`` (``batched_toa_fluxes``)
or ``rce`` (``rce_device.batched_rce`` with the JAX script's tight
iteration budget). One warm-up call, then ``--iters`` (>= 10 by default)
timed calls, each the slowest rank's seconds around its call (the results
are all-gathered, so the ranks finish together). Reports the median and the
interquartile range, columns/s, the efficiency against one rank and the
ranks' exit codes.

    python -m clima_tpu_torch.tools.scaling [--devices 1 2 4 8] [--columns-per-device 8]
        [--iters 10] [--workloads toa rce] [--nz 20] [--device cpu] [--out FILE]

``--devices`` larger than the number of cards raises; on the CPU
(``--device cpu``) the ranks are processes on gloo.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import socket
import tempfile

import numpy as np
import torch

__all__ = ["main", "inputs"]

# how long one spawn of the ranks may take, model builds and calls included
SPAWN_TIMEOUT_S = 3600.0


def inputs(ng, species_names, B):
    """The JAX script's batch: H2O 270 bar, CO2 200..800 dyn/cm^2, N2 1 bar;
    T_surf 270..300 K."""
    P_i = np.full((B, ng), 1.0e-15)
    P_i[:, species_names.index("H2O")] = 270.0e6
    P_i[:, species_names.index("CO2")] = np.linspace(200.0, 800.0, B)
    P_i[:, species_names.index("N2")] = 1.0e6
    return P_i, np.linspace(270.0, 300.0, B)


def _free_port():
    with contextlib.closing(socket.socket()) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _calls(workload, model, B, nz, iters):
    from ..adiabat import rce_device
    from ..data import make_template
    from ..config import species_from_dict
    from ..parallel import batched_toa_fluxes

    sp = species_from_dict(make_template(nz=nz, n_zenith=1)["species"])
    P_i, T_surf = inputs(sp.ng, list(sp.gas_names), B)
    calls = []
    for i in range(iters + 1):
        scale = 1.0 if i == 0 else 1.0 + 1e-6 * i
        name = "warmup" if i == 0 else f"iter{i}"
        if workload == "toa":
            calls.append((name, model, batched_toa_fluxes, (T_surf * scale, P_i), {}))
        else:
            T_seed = np.tile(np.linspace(285.0, 210.0, nz), (B, 1))
            calls.append((name, model, rce_device.batched_rce, (P_i, T_surf * scale, T_seed),
                          dict(flux_precision="standard", max_newton_iters=4, max_ptc_steps=4,
                               max_total_iters=8)))
    return calls


def main(argv=None):
    """Run every (workload, rank count); returns the records (also written to
    ``--out``), each printed as a JSON line."""
    ap = argparse.ArgumentParser(prog="python -m clima_tpu_torch.tools.scaling",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--columns-per-device", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--nz", type=int, default=20)
    ap.add_argument("--workloads", nargs="+", default=["toa", "rce"], choices=["toa", "rce"])
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the cards)")
    ap.add_argument("--out", default=None, help="write the records to this JSON file")
    args = ap.parse_args(argv)

    from . import distributed_worker
    from ..utils.device import resolve_device

    on_cpu = resolve_device(args.device).type == "cpu"
    n_avail = None if on_cpu else torch.cuda.device_count()
    counts = args.devices or sorted({n for n in (1, 2, 4, 8, n_avail) if n <= n_avail})
    if not on_cpu and max(counts) > n_avail:
        raise ValueError(f"--devices {max(counts)} is more than the {n_avail} CUDA card(s) "
                         "here: the mesh runs one rank per card")
    model = dict(nz=args.nz, n_zenith=1, device="cpu" if on_cpu else None)
    backend = "gloo" if on_cpu else "nccl"
    results = []
    for workload in args.workloads:
        base_rate = None
        for nd in counts:
            B = args.columns_per_device * nd
            out_dir = tempfile.mkdtemp(prefix="clima_tpu_torch_scaling_")
            try:
                ctx = distributed_worker.start(
                    nd, _calls(workload, model, B, args.nz, args.iters), out_dir,
                    backend=backend, coordinator=f"127.0.0.1:{_free_port()}",
                    threads=1 if on_cpu else None)
                ranks = distributed_worker.join(ctx, out_dir, SPAWN_TIMEOUT_S)
                exitcodes = [p.exitcode for p in ctx.processes]
            finally:
                shutil.rmtree(out_dir, ignore_errors=True)
            times = np.sort([max(r[f"iter{i}"][1] for r in ranks)
                             for i in range(1, args.iters + 1)])
            med = float(np.median(times))
            q1, q3 = (float(np.percentile(times, q)) for q in (25, 75))
            rate = B / med
            if base_rate is None:
                base_rate = rate / nd
            launches = {}
            for r in ranks:
                for i in range(1, args.iters + 1):
                    for k, n in r[f"iter{i}"][2].items():
                        launches[k] = launches.get(k, 0) + n
            rec = dict(workload=workload, devices=nd, columns=B, iters=args.iters, nz=args.nz,
                       backend=backend, warmup_s=max(r["warmup"][1] for r in ranks),
                       wall_s_median=med, wall_s_iqr=[q1, q3], wall_s_all=times.tolist(),
                       columns_per_s=rate, efficiency_vs_1dev=rate / (base_rate * nd),
                       efficiency_spread_est=(q3 - q1) / med if med else 0.0,
                       rank_exitcodes=exitcodes, launches=launches)
            results.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
