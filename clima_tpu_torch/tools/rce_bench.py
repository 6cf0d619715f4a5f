"""Batched device RCE over column ensembles (the port of the JAX package's
``scripts/rce_bench.py``).

Runs ``rce_device.batched_rce`` at the reference RCE-test configuration
(``--nz`` 50 layers, one zenith angle, ``tests/settings_RCE_test.yaml``)
over heterogeneous ensembles of ``--sizes`` columns (8, 64 and 256 by
default): CO2 log-spaced 100..6400 ppm, every lane warm-started from one
``surface_temperature`` solution of the 400 ppm column with jittered
T_surf and T guesses (seed 7, as the JAX script). Each size runs twice,
the second time on perturbed inputs with ``batched_rce``'s built functions
kept. The second call still captures its moist-adiabat and altitude CUDA
graphs anew, nearly as many as the first (ROADMAP Queue 2, B0: these
graphs are not cached yet), so neither run is the execution cost alone.
Records, of the second run, columns/s over the whole call
(``columns_per_s_with_capture``) and over its time outside graph capture
(``columns_per_s_without_capture``); each lane's status, the rc/solve
iteration spread, and for each run the seconds capturing CUDA graphs and the
rest, the captures and the kernels' launches.

Float64 throughout: ``--precision df64`` (the JAX default, its float32-pair
flux accumulation for TPUs) means float64 here, as everywhere in the port.
A batched loop runs until the slowest lane stops, so columns/s charges the
ensemble's spread.

    python -m clima_tpu_torch.tools.rce_bench [--nz 50] [--sizes 8 64 256] [--xtol 1e-5]
        [--precision df64] [--substeps 6] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

__all__ = ["main"]


def _wrappers():
    """The device RCE path's kernels by name: their wrappers count launches."""
    from ..ops import rorr_cuda, twostream_cuda

    return {"two_stream_ir_weighted": twostream_cuda.two_stream_ir_weighted_cuda,
            "two_stream_solar_multi_weighted": twostream_cuda.two_stream_solar_multi_weighted_cuda,
            "k_rorr_mix": rorr_cuda.k_rorr_mix_cuda}


def _spread(x):
    x = np.asarray(x)
    return dict(min=int(x.min()), median=float(np.median(x)), max=int(x.max()))


def main(argv=None):
    """Run the ensembles; returns the result dict (also written to ``--out``)."""
    ap = argparse.ArgumentParser(prog="python -m clima_tpu_torch.tools.rce_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--nz", type=int, default=50)
    ap.add_argument("--sizes", type=int, nargs="+", default=[8, 64, 256])
    ap.add_argument("--xtol", type=float, default=1.0e-5)
    ap.add_argument("--precision", default="df64", choices=["df64", "standard", "auto"])
    ap.add_argument("--jac-budget", type=int, default=96,
                    help="B * jac_chunk: bounds the FD Jacobian's columns per IR call")
    ap.add_argument("--chunk-iters", type=int, default=12,
                    help="inner iterations per pass of batched_rce (warm-restarted passes)")
    ap.add_argument("--substeps", type=int, default=None,
                    help="RK4 substeps per profile interval (default: the model's, 6)")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--out", default=None, help="write the result to this JSON file")
    args = ap.parse_args(argv)

    from ..adiabat import AdiabatClimate
    from ..adiabat.rce_device import batched_rce
    from ..data import make_template
    from ..ops.cuda_graph import CAPTURE_SECONDS, CAPTURES
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    tpl = make_template(nz=args.nz, n_zenith=1)
    c = AdiabatClimate(tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"],
                       device=device, **({} if args.substeps is None else
                                         {"substeps": args.substeps}))
    c.verbose = False
    c.xtol_rc = args.xtol
    wrappers = _wrappers()
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = dict(device=str(device), kind=kind, nz=args.nz, substeps=c.substeps,
                  xtol_rc=args.xtol, flux_precision=args.precision, dtype="float64", runs=[])

    rng = np.random.default_rng(7)
    iH2O, iCO2, iN2 = (c.species_names.index(s) for s in ("H2O", "CO2", "N2"))
    # every lane warm-starts from one surface_temperature solution of the
    # 400 ppm column (test_adiabat.f90:163-252: surface_temperature, then RCE)
    P_ref = np.full(c.sp.ng, 1.0e-15)
    P_ref[iH2O], P_ref[iCO2], P_ref[iN2] = 270.0e6, 400.0, 1.0e6
    t0 = time.perf_counter()
    T_surf_ref = c.surface_temperature(P_ref, T_guess=280.0)
    T_ref = c.T.copy()
    result["warm_start"] = dict(T_surf=float(T_surf_ref), seconds=time.perf_counter() - t0)

    def run(P_b, T_s, T_seed, jac_chunk, cache):
        for w in wrappers.values():
            w.launches = 0
        cap_s, caps = sum(CAPTURE_SECONDS.values()), sum(CAPTURES.values())
        sync()
        t0 = time.perf_counter()
        out = batched_rce(c, P_b, T_s, T_seed, flux_precision=args.precision,
                          chunk_iters=args.chunk_iters, jac_chunk=jac_chunk, _cache=cache)
        out = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in out.items()}
        wall = time.perf_counter() - t0
        capture = sum(CAPTURE_SECONDS.values()) - cap_s
        return out, dict(wall_s=wall, capture_s=capture, rest_s=wall - capture,
                         captures=sum(CAPTURES.values()) - caps,
                         launches={k: w.launches for k, w in wrappers.items()})

    for B in args.sizes:
        P_b = np.full((B, c.sp.ng), 1.0e-15)
        P_b[:, iH2O] = 270.0e6
        P_b[:, iCO2] = 1.0e6 * np.geomspace(100e-6, 6400e-6, B)
        P_b[:, iN2] = 1.0e6
        T_s = T_surf_ref + rng.uniform(-2.0, 2.0, B)
        T_seed = T_ref[None, :] + rng.uniform(-1.0, 1.0, (B, 1))
        jac_chunk = max(1, args.jac_budget // B)
        cache = {}
        _, first = run(P_b, T_s, T_seed, jac_chunk, cache)
        # the same built functions on perturbed inputs: the execution cost
        T_s2 = T_s + rng.uniform(-1.0, 1.0, B)
        out, second = run(P_b * (1.0 + 1e-4), T_s2, T_seed, jac_chunk, cache)
        status = out["status"].astype(int)
        rec = dict(
            B=B, jac_chunk=jac_chunk, first=first, second=second,
            columns_per_s_with_capture=B / second["wall_s"],
            columns_per_s_without_capture=B / second["rest_s"],
            converged_frac=float(out["converged"].mean()),
            status=status.tolist(),
            status_counts={int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))},
            max_ratio_max=float(out["max_ratio"].max()),
            ratio_floor_max=float(out["ratio_floor"].max()),
            solve_iters=_spread(out["solve_iters"]), rc_iters=_spread(out["rc_iters"]),
            T_surf_range=[float(out["T_surf"].min()), float(out["T_surf"].max())],
            finite=bool(np.isfinite(out["T"]).all() and np.isfinite(out["T_surf"]).all()),
        )
        result["runs"].append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
