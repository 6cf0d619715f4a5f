"""Smoke run of the PyTorch + CUDA port (clima_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. environment: torch / CUDA versions and the card's name and power limit;
   fails without a CUDA device (there is no CPU path);
2. build: the CUDA kernels from clima_tpu_torch/csrc/, one nvcc per source,
   started together, with build seconds and ptxas's registers, stack and
   spills for each kernel instance; fails if any instance spills;
3. each kernel against its plain PyTorch twin on the card, float64:
   a. the weight-fused kernels of the radtran path at the flagship shapes
      (IR two-stream with hard and soft surface and a thin layer, timed, and
      timed in float32 too, where its output must be finite and its
      deviation from the float64 twin is printed beside the float32 twin's
      own, then held to the float32 twin on the Planck function of a
      temperature column, and to the float64 twin on such inputs without
      layers where float32 cancels, at a limit that a known-wrong float32
      result (the twin without its thin-layer branch) must exceed; the
      weighted solar kernel with 4 zenith angles, with and without amean,
      both timed, and timed in float32 too, where its output must be
      finite and its deviation from the float64 twin is printed beside the
      float32 twin's own; RORR with 3 species at nbin 8 and 16, both timed
      beside the sort twin, and at nbin 8 in float32, timed and held to the
      float32 twin), at smaller shapes the weighted solar kernel at 6 and
      12 zenith angles and RORR at a run-time nbin (12), plus the float32
      near-tie RORR chain; then the nbin > 16 sort path (nbin 20, in lane
      chunks) once at the radtran path's full lane count, with its time and
      peak memory, checked against the unchunked sort path on its first
      lanes;
   b. the unreduced kernels through their dispatchers
      ``two_stream_{ir,solar_multi,solar}_auto`` (the weighted IR kernel
      with one gauss point of weight 1, the unreduced multi-zenith and
      single-zenith solar kernels) at the shapes of the JAX
      package's roofline entry point (scripts/roofline.py: rows = 256*60*8,
      nz = 202, the 4 Gauss zenith cosines shared by all rows, or cycled
      over the rows for the single-zenith kernel; IR with a hard and a soft
      surface and a thin layer), and the multi-zenith kernel again at 12
      zenith angles (one launch; the (zenith, row) pairs with a layer
      within 1e-4 of the lam^2 = 1/u0^2 resonance of the solar source, where
      kernel and twin alike amplify roundoff, are counted and must be
      finite, the others are held to the twin), timed at 4 and 12 zenith
      angles, the twins compared in row chunks;
   kernel and twin times (CUDA events after a warm-up) and each kernel's
   bound: the larger of its bytes over 3.35 TB/s and its float64
   operations over 34 TFLOP/s (NVIDIA H100 SXM data sheet, non-tensor FP64);
4. the radtran path: the synthetic nz=100, 4-zenith template built in
   memory, ``Radtran`` constructed on the card and run on one column, then
   the B=256 columns x K=4 bench-shaped batch (nz_r = 202 layers, 51 bins,
   8 gauss points, 3 k-species) through compute_opacity -> radiate_ir /
   radiate_solar -> integrate_fluxes, checked against the same calls with
   the three kernels swapped for their plain twins (ISR/OLR rtol 1e-9),
   the batch time and two-stream solves/s, and one batch under
   torch.profiler for its device time by kernel;
5. the adiabat path, the ``__graft_entry__.entry`` workload: the nz=50,
   4-zenith template, ``AdiabatClimate`` on the card and
   ``make_column_fns(c)["toa_fluxes"]`` over B=8 columns (moist adiabat ->
   altitude -> opacity/RORR -> IR + solar two-stream -> TOA fluxes), checked
   against the same call with the three kernels swapped for their twins
   (rtol 1e-9); then one ``surface_temperature`` solve on the card for the
   first column, checked against the same solve by the port on the CPU
   (rtol 1e-8, run in a child process while the card works). Reports the
   batch time, the three kernels' times at the path's shapes, the march's
   operations per profile and its time with and without the CUDA graph of
   one interval (and the capture seconds), the solve's time and
   evaluations, and peak memory;
6. the RCE path: the nz=20, 4-zenith template (surface albedo 0.3),
   ``AdiabatClimate`` on the card at substeps=6, float64, warm-started by
   ``surface_temperature``, then ``c.RCE(P_i, T_surf, c.T)`` (the RC march
   replaying its cached interval graph, HYBRJ/PTC on the host, one objective
   evaluation = RORR + #1 + #2, one FD Jacobian = one batched call of #1 over
   the perturbed columns). It must converge, capture the RC graph once and
   launch each of the three kernels. At the final state the objective's
   per-bin fluxes and net fluxes and the batched IR call are checked against
   the same calls with the three kernels swapped for their twins (rtol 1e-9,
   atol 1e-12; ``f_total``, whose top entries cancel to ~xtol_rc of the flux
   scale, at rtol 1e-9 of that scale), and a CPU process of the port rebuilds
   the profile and the objective at the card's final state (P, T, z, lapse
   rates rtol 1e-9, ``f_total`` as above). Reports the mode iterations,
   evaluations, Jacobians, final mask, T_surf, the time split (march,
   radiative transfer, the Jacobian's IR batch, the rest on the host), the
   graph captures, peak memory, the kernels' launches and times at the
   path's shapes and #1's largest row count;
7. the batched solver path: ``parallel.batched_surface_temperature_column``
   on phase 5's template cut to nz=20 (SOLVER_NZ) over the entry batch's 8
   columns, the targets their
   inventories N_atmos + N_surface from ``profile_only`` on the card (the
   joint system of T_surf and the ng partial pressures, each residual one
   batched ``column_model`` call through RORR, #1 and #2). Every lane must
   converge (status 0) and each of the three kernels launch; at the
   solution ISR/OLR through the kernels are checked against the twins
   (rtol 1e-9), and a CPU process of the port evaluates ``column_model``
   and ``profile_only`` there (ISR, OLR, N rtol 1e-8; its residual norm
   below 2 tol). Reports the solve's seconds, its ``column_model`` calls
   with their column counts and seconds, the graph captures and their
   seconds, peak memory, and the three kernels' times back to back and
   bounds at the line search's shape (the largest call);
8. the device RCE path: ``rce_device.batched_rce`` on phase 6's model over
   B=4 lanes (H2O 270 bar, N2 1 bar, CO2 200, 400, 800 and 1600 dyn/cm^2,
   scripts/rce_bench.py's geometric spread cut to four lanes), each
   warm-started from phase 6's ``surface_temperature`` solution: the batched
   RC march (its graph captured once per batch size), every objective one
   RORR + #1 + #2 call over all lanes, every FD Jacobian one batched #1 call
   over all lanes' perturbations, the Newton/PTC stages and mask updates as
   array operations over the lanes. Every lane must converge (status 0,
   max|F/F0| < xtol_rc) and each of the three kernels launch; lane 1 (phase
   6's column) must have phase 6's host mask, T_surf within 0.5 K and T
   within 2 K (tests/test_rce_device.py's limits); each kernel is held
   against its twin on the last inputs the path gave it at each of its
   shapes (as phase 7); a CPU process of the port evaluates the objective
   at the card's final state (T, P, z, lapse rates rtol 1e-9, ``f_total``
   at rtol 1e-9 of the flux scale, its max|F/F0| below xtol_rc). Reports
   each lane's status and iterations, the objective evaluations and
   Jacobians, the time split (march, altitude, radiative transfer, the
   Jacobian's IR batches, the host rest), the marches by batch size, the
   graph captures, peak memory, and each kernel's time and bound at the
   path's largest shape;
9. the Climate path: ``Climate`` with tests/test_climate.py's settings and
   atmosphere column at nz=50, 4 zenith angles, from T_init over
   logspace(4, 6, 10) s (examples/climate_evolve.py): ``evolve`` with
   DOP853 (host scipy, each RHS one radiative transfer through the facade)
   and with rk45_device (the state on the card), both at rtol 1e-7 and held
   to each other (T rtol 1e-4, atol 1e-3), then DOP853 at the model's
   default tolerances, its gap printed; every field of every stream finite,
   each kernel launched in each evolve and no twin called. Each kernel
   against its twin on the path's last inputs at each shape (one column,
   the 10-snapshot batch), timed with its bound; a CPU process of the port
   evaluates ``right_hand_side`` and ``fluxes_fn`` at the last three
   snapshots (dT/dt rtol 1e-9 with a per-layer atol of a 1e-12 flux error,
   fluxes 1e-9 of each array's largest value). Reports each evolve's RHS
   evaluations, attempted/accepted/rejected steps, seconds and ms per RHS,
   one RHS split into radiative transfer and the rest, one profiler pass
   over an RHS, and peak memory.

10. the sharded path: the batched entry points with ``mesh=make_mesh()``,
    each rank a process of ``clima_tpu_torch.tools.distributed_worker``
    building its own models. (a) Two gloo ranks sharing the card: phase 5's
    ``batched_toa_fluxes`` over the entry batch (4 columns per rank) and
    phase 8's ``batched_rce`` lanes on the template cut to nz=12 (2 lanes
    per rank), from that model's ``surface_temperature`` warm start. Both
    ranks must gather the same results, held to the unsharded ones: the TOA
    fluxes to phase 5's at rtol 1e-12, the RCE lanes to ``batched_rce``
    without a mesh in this process (run while the ranks work), all status 0
    with its masks and T_surf/T at rtol 1e-7; each largest gap is printed
    and whether it is bitwise. (b) One NCCL rank
    (``initialize_distributed(num_processes=1, process_id=0)`` with the
    default backend, the rendezvous in the environment): the TOA fluxes
    must equal phase 5's bitwise. The three kernels must launch in every
    rank's every call; the ranks run together, and the phase's seconds are
    printed.
11. the examples and the tools: each of ``clima_tpu_torch.examples``'
    ``main()`` at its own size (``modern_earth_radtran``: Radtran at nz=50
    with 8 zenith angles and a haze, its custom-opacity round trip;
    ``tutorial_adiabat_climate``: TOA fluxes, ``surface_temperature`` and
    ``RCE`` at nz=20; ``early_mars``: ``batched_surface_temperature`` over
    six CO2 inventories on ``make_mesh()``; ``climate_evolve``: ``Climate``
    at nz=20 over logspace(4, 6, 10) s), each finite, converged where it
    reports it, its files read back, each launching #1, #2 and RORR, none
    calling a twin, and each kernel then held to its twin on the last inputs
    the example gave it at each of its shapes (as phases 7-9); then each
    tool once: ``tools.roofline`` at phase 3b's shapes (every kernel timed
    within its bound, all six launched), ``tools.validation`` at nz=8: its
    kernel parity (each output's largest difference over its largest value
    within the tool's fixed limit, 1e-9 or 2e-9 for #4) and its device RCE
    against the CPU's host RCE in a child process (every lane status 0; the
    CPU's mask, T_surf within 5e-3 K and T within 0.1 K, the tool's
    RCE_LIMITS), ``tools.rce_bench`` over 4 lanes at nz=8 (every lane status
    0) and ``tools.scaling`` over one NCCL rank (toa, 3 timed calls; the
    rank exits 0 and launches the three kernels). Each call's seconds are
    printed. ``early_mars`` (started with phase 10) and
    ``tutorial_adiabat_climate`` run each in a process of its own on the
    card, and the validation tool's CPU reference in a child process, each
    running beside the rest (the paths are host-bound: the card idles
    between launches).

Each path runs with the kernels' launch counts set to 0 just before it and
read just after (the sharded path's in each rank's process); the kernels of
a path must each have launched. The second-to-last line is a JSON object
with each kernel's numbers (its launches summed over the radtran, adiabat,
RCE, solver, device RCE, Climate, sharded and phase 11's paths); the last
line is the device JSON.
"""

import collections
import contextlib
import functools
import io
import json
import multiprocessing
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from unittest import mock

import numpy as np
import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from clima_tpu_torch import constants  # noqa: E402
from clima_tpu_torch.adiabat import AdiabatClimate, rce, rce_device  # noqa: E402
from clima_tpu_torch.adiabat import profile as adiabat_profile  # noqa: E402
from clima_tpu_torch.climate import Climate, load_evolve_file  # noqa: E402
from clima_tpu_torch.climate.climate import CP_GROUND, DZ_GROUND, RHO_GROUND  # noqa: E402
from clima_tpu_torch.config import settings_from_dict, species_from_dict  # noqa: E402
from clima_tpu_torch.config.species import heat_capacity  # noqa: E402
from clima_tpu_torch.data import (climate_settings_yaml_text, make_template,  # noqa: E402
                                  write_atmosphere_file)
from clima_tpu_torch.ops import cuda_build, rorr_cuda, twostream, twostream_cuda  # noqa: E402
from clima_tpu_torch.ops.cuda_graph import CAPTURE_SECONDS, CAPTURES  # noqa: E402
from clima_tpu_torch.ops.rorr import k_rorr_mix  # noqa: E402
from clima_tpu_torch import parallel  # noqa: E402
from clima_tpu_torch.parallel import make_column_fns, solvers  # noqa: E402
from clima_tpu_torch.physics import eqns  # noqa: E402
from clima_tpu_torch.radtran import Radtran, opacity, radiate  # noqa: E402
from clima_tpu_torch.config.atmosphere_file import AtmosphereFile  # noqa: E402
from clima_tpu_torch.examples import (climate_evolve, early_mars,  # noqa: E402
                                      modern_earth_radtran, tutorial_adiabat_climate)
from clima_tpu_torch.tools import (distributed_worker, rce_bench, roofline,  # noqa: E402
                                   scaling, validation)

RTOL, ATOL = 1e-9, 1e-12
B_COLS, K_INNER, NZ_TEMPLATE, N_ZEN = 256, 4, 100, 4
NZ_R = 2 * NZ_TEMPLATE + 2  # flagship radiative grid (doubled + ghosts)
ROOFLINE_ROWS, ROOFLINE_NZ = 256 * 60 * 8, 202  # scripts/roofline.py:69-71
ENTRY_B, ENTRY_NZ = 8, 50  # __graft_entry__.entry
# phase 7's depth, cut from the entry model's 50 layers to keep the script
# within its time with phase 11 (the same bins, species and 4 zenith angles)
SOLVER_NZ = 20
RCE_NZ, RCE_SUBSTEPS = 20, 6  # tests/test_rce.py:17-18's depth
# phase 10's RCE lanes at a depth cut to 12, which keeps the script within
# half its time limit
SHARDED_RCE_NZ = 12

# each wrapper, its CUDA kernel (the __global__ function in ``source``) and
# the TPU kernel it replaces
KERNELS = {
    "two_stream_ir_weighted": dict(
        wrapper=twostream_cuda.two_stream_ir_weighted_cuda, kernel="ir_weighted_kernel",
        source="clima_tpu_torch/csrc/twostream.cu",
        replaces="clima_tpu/ops/pallas_twostream.py:261"),
    "two_stream_solar_multi_weighted": dict(
        wrapper=twostream_cuda.two_stream_solar_multi_weighted_cuda,
        kernel="solar_weighted_kernel", source="clima_tpu_torch/csrc/twostream.cu",
        replaces="clima_tpu/ops/pallas_twostream.py:194"),
    "k_rorr_mix": dict(
        wrapper=rorr_cuda.k_rorr_mix_cuda, kernel="rorr_chain_kernel",
        source="clima_tpu_torch/csrc/rorr.cu",
        replaces="clima_tpu/ops/pallas_rorr.py:145"),
    "two_stream_ir": dict(
        wrapper=twostream_cuda.two_stream_ir_auto, kernel="ir_weighted_kernel, nG = 1",
        source="clima_tpu_torch/csrc/twostream.cu",
        replaces="clima_tpu/ops/pallas_twostream.py:303"),
    "two_stream_solar_multi": dict(
        wrapper=twostream_cuda.two_stream_solar_multi_auto, kernel="solar_rows_kernel",
        source="clima_tpu_torch/csrc/twostream.cu",
        replaces="clima_tpu/ops/pallas_twostream.py:107"),
    "two_stream_solar": dict(
        wrapper=twostream_cuda.two_stream_solar_auto, kernel="solar_single_kernel",
        source="clima_tpu_torch/csrc/twostream.cu",
        replaces="clima_tpu/ops/pallas_twostream.py:68"),
}
RADTRAN_KERNELS = ("two_stream_ir_weighted", "two_stream_solar_multi_weighted", "k_rorr_mix")
DISPATCH_KERNELS = ("two_stream_ir", "two_stream_solar_multi", "two_stream_solar")
RESULTS = {name: {"max_abs_err": 0.0, "library_ms": None} for name in KERNELS}
# phase 5's unsharded TOA fluxes, which phase 10 holds the sharded path to
UNSHARDED = {}


def sync(device):
    torch.cuda.synchronize(device)


def median_ms(fn, device, reps=10, warmup=2):
    """Median wall time of fn() in ms, each run closed by a device sync."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def event_ms(fn, device, reps=5):
    """Mean device time of fn() in ms over ``reps`` back-to-back runs, CUDA
    events, after one warm-up run."""
    fn()
    sync(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync(device)
    return start.elapsed_time(end) / reps


def set_bound(name, work):
    """The least time the card could take for ``work`` (bytes, float64
    operations), as ``tools/roofline.py`` counts it: bytes over the memory
    rate or operations over the FP64 peak, whichever is larger."""
    RESULTS[name]["bound_ms"], RESULTS[name]["bound_by"] = roofline.bound(*work)


def compare(name, got, want, rtol=RTOL, atol=ATOL):
    """allclose(got, want, rtol, atol) for each pair, or raise; records the
    max abs error under kernel ``name``."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        if g.shape != w.shape:
            raise AssertionError(f"{name}[{i}]: shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}[{i}]: non-finite kernel output")
        err = (g - w).abs()
        abs_err = float(err.max())
        rel_err = float((err / w.abs().clamp(min=1e-300)).max())
        excess = float((err - atol - rtol * w.abs()).max())
        print(f"  {name}[{i}] shape={tuple(g.shape)} max_abs_err={abs_err:.3e} "
              f"max_rel_err={rel_err:.3e}")
        if excess > 0:
            raise AssertionError(f"{name}[{i}] outside rtol={rtol}, atol={atol}")
        if name in RESULTS:
            RESULTS[name]["max_abs_err"] = max(RESULTS[name]["max_abs_err"], abs_err)


def phase_environment():
    print("== phase 1: environment")
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False; chip_smoke.py needs a CUDA device")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    # precision-sensitive contractions must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(dev)}  count {torch.cuda.device_count()}")
    return dev, smi.splitlines()[0]


def phase_build():
    print("== phase 2: build")
    names = ("twostream", "rorr")
    errors = []

    def build(name):
        try:
            cuda_build.load_library(name)
        except Exception as e:  # re-raised below, after every build has ended
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"  built in {time.perf_counter() - t0:.2f} s wall")
    spills = []
    for name in names:
        info = cuda_build.BUILD_INFO[name]
        print(f"  {name}: {info['seconds']:.2f} s")
        fn = None
        for line in info["log"].splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for", 1)[1].strip()
                print("   ", fn)
            elif "registers" in line or "spill" in line:
                print("     ", line.strip())
                stores = re.search(r"(\d+) bytes spill stores", line)
                if stores and int(stores.group(1)) > 0:
                    spills.append(fn)
    if spills:
        raise AssertionError(f"kernel instances spill to local memory: {sorted(set(spills))}")


def _atm(gen, rows, nz, device):
    """Random optical properties in the ranges of the JAX package's kernel tests."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((rows, nz), generator=gen, dtype=torch.float64,
                                                   device=device)
    return u(1e-6, 2.0), u(0.02, 0.999), u(0.0, 0.85)


def phase_kernels(device, B=B_COLS, nz=NZ_R, nw_ir=28, nw_sol=32, nw=51, nG=8,
                  nbin_list=(8, 16), reps=5):
    print("== phase 3a: weight-fused kernels against their twins, float64")
    gen = torch.Generator(device=device).manual_seed(0)
    rand = lambda *shape: torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    wbin = torch.tensor(np.polynomial.legendre.leggauss(nG)[1] / 2.0, device=device)

    # IR: rows = B*28*8, hard and soft surface, one thin layer
    rows = B * nw_ir * nG
    tau, w0, gt = _atm(gen, rows, nz, device)
    tau[2, 5] = 1e-7
    emis = 0.8 + 0.2 * rand(rows)
    bpl = 1e-2 + rand(rows, nz + 1)
    ir_args = lambda hard: (tau, w0, gt, emis, hard, 1e-6, bpl, wbin)
    for hard in (True, False):
        compare("two_stream_ir_weighted", twostream_cuda.two_stream_ir_weighted_cuda(*ir_args(hard)),
                twostream.two_stream_ir_weighted(*ir_args(hard)))
        sync(device)
    r = RESULTS["two_stream_ir_weighted"]
    r["ms"] = event_ms(lambda: twostream_cuda.two_stream_ir_weighted_cuda(*ir_args(True)), device, reps)
    r["plain_ms"] = event_ms(lambda: twostream.two_stream_ir_weighted(*ir_args(True)), device, 2)
    set_bound("two_stream_ir_weighted", roofline.ir_weighted_work(rows, nz, nG))
    print(f"  IR rows={rows} nz={nz}: kernel {r['ms']:.3f} ms, twin {r['plain_ms']:.3f} ms, "
          f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    # float32, timed on the same inputs: the output must be finite, and its
    # deviation from the float64 twin is printed beside the float32 twin's
    # own (under random Planck values the linear-in-tau source of thin layers
    # cancels in float32, in the twin alike); then held to the float32 twin at
    # 1e-4 of the largest value on the Planck function of a temperature column
    ir_ms = lambda args: event_ms(lambda: twostream_cuda.two_stream_ir_weighted_cuda(*args),
                                  device, reps)
    args32 = [a.float() if torch.is_tensor(a) else a for a in ir_args(True)]
    want64 = twostream.two_stream_ir_weighted(*ir_args(True))
    got32 = twostream_cuda.two_stream_ir_weighted_cuda(*args32)
    twin32 = twostream.two_stream_ir_weighted(*args32)
    if not all(bool(torch.isfinite(x).all()) for x in got32):
        raise AssertionError("non-finite float32 IR kernel output")
    dev64 = lambda xs: max(float((x.double() - w).abs().max() / w.abs().max())
                           for x, w in zip(xs, want64))
    print(f"  IR float32: kernel {ir_ms(args32):.3f} ms; largest deviation from the float64 "
          f"twin over its largest value: kernel {dev64(got32):.3e}, float32 twin "
          f"{dev64(twin32):.3e}")
    del args32, want64, got32, twin32
    gen_t = torch.Generator(device=device).manual_seed(1)
    rand_t = lambda *shape: torch.rand(shape, generator=gen_t, dtype=torch.float64, device=device)
    T_col = torch.linspace(290.0, 180.0, nz + 1, dtype=torch.float64, device=device)
    freq = 10.0 ** (12.5 + 1.5 * rand_t(rows // nG, 1))
    bpl_t = eqns.planck_fcn(freq, T_col[None, :] + 10.0 * (rand_t(rows // nG, 1) - 0.5))
    args64 = list(ir_args(True))
    args64[6] = bpl_t.repeat_interleave(nG, dim=0)
    maxrel = lambda xs, ws: max(float((x.double() - w.double()).abs().max()
                                      / w.double().abs().max()) for x, w in zip(xs, ws))
    # a known-wrong float32 result: the twin without its thin-layer branch
    # (tau_min 0), which in float64 moves the outputs by rounding only
    wrong = lambda a: twostream.two_stream_ir_weighted(*a[:5], 0.0, *a[6:])
    args32 = [a.float() if torch.is_tensor(a) else a for a in args64]
    got32 = twostream_cuda.two_stream_ir_weighted_cuda(*args32)
    twin32 = twostream.two_stream_ir_weighted(*args32)
    want64 = twostream.two_stream_ir_weighted(*args64)
    maxrel_twin = maxrel(got32, twin32)
    print(f"  IR float32 on Planck values of a temperature column, largest deviation over the "
          f"largest value: kernel from the float32 twin {maxrel_twin:.3e} (limit 1e-4), from "
          f"the float64 twin {maxrel(got32, want64):.3e}; float32 twin from the float64 twin "
          f"{maxrel(twin32, want64):.3e}; known-wrong control from the float64 twin "
          f"{maxrel(wrong(args32), want64):.3e}, from the float32 twin "
          f"{maxrel(wrong(args32), twin32):.3e}")
    if not (all(bool(torch.isfinite(x).all()) for x in got32) and maxrel_twin < 1e-4):
        raise AssertionError(f"float32 IR kernel deviates from its twin: {maxrel_twin:.3e}")
    # where float32 is well conditioned: no layer between tau_min and 1e-2
    # (the source of such layers cancels), the top layer of every row thin
    # (1e-7, as at the top of a column), so every row takes the thin-layer
    # branch; held to the float64 twin at 1e-5 of the largest value, a limit
    # the known-wrong control must exceed
    args64[0] = 1e-2 + (2.0 - 1e-2) * rand_t(rows, nz)
    args64[0][:, 0] = 1e-7
    args32 = [a.float() if torch.is_tensor(a) else a for a in args64]
    got32 = twostream_cuda.two_stream_ir_weighted_cuda(*args32)
    want64 = twostream.two_stream_ir_weighted(*args64)
    r_kernel, r_wrong = maxrel(got32, want64), maxrel(wrong(args32), want64)
    print(f"  IR float32, no layer with tau in (1e-6, 1e-2), thin top layers: largest deviation "
          f"from the float64 twin over its largest value: kernel {r_kernel:.3e}, float32 twin "
          f"{maxrel(twostream.two_stream_ir_weighted(*args32), want64):.3e}, known-wrong "
          f"control {r_wrong:.3e} (limit 1e-5)")
    if not (all(bool(torch.isfinite(x).all()) for x in got32) and r_kernel < 1e-5):
        raise AssertionError(f"float32 IR kernel deviates from the float64 twin: {r_kernel:.3e}")
    if not r_wrong > 1e-5:
        raise AssertionError(f"the float32 limit does not tell the known-wrong control: "
                             f"{r_wrong:.3e}")
    del tau, w0, gt, emis, bpl, args64, args32, got32, twin32, want64, bpl_t

    # solar: rows = B*32*8, 4 zenith angles, with and without amean
    rows = B * nw_sol * nG
    tau, w0, gt = _atm(gen, rows, nz, device)
    ang, zw = eqns.zenith_angles_and_weights(N_ZEN)
    u0s = torch.tensor(np.cos(ang * np.pi / 180.0), device=device)
    zw = torch.tensor(zw, device=device)
    rs = 0.6 * rand(rows)
    sol_args = (tau, w0, gt, u0s, rs, zw, wbin)
    for am in (True, False):
        compare("two_stream_solar_multi_weighted",
                twostream_cuda.two_stream_solar_multi_weighted_cuda(*sol_args, with_amean=am),
                twostream.two_stream_solar_multi_weighted(*sol_args, with_amean=am))
        sync(device)
    r = RESULTS["two_stream_solar_multi_weighted"]
    sol_ms = lambda args, am: event_ms(lambda: twostream_cuda.two_stream_solar_multi_weighted_cuda(
        *args, with_amean=am), device, reps)
    r["ms"] = sol_ms(sol_args, False)
    r["plain_ms"] = event_ms(lambda: twostream.two_stream_solar_multi_weighted(
        *sol_args, with_amean=False), device, 2)
    set_bound("two_stream_solar_multi_weighted",
              roofline.solar_weighted_work(rows, nz, N_ZEN, nG))
    print(f"  solar rows={rows} nz={nz} nzen={N_ZEN}: kernel {r['ms']:.3f} ms (amean on "
          f"{sol_ms(sol_args, True):.3f} ms), twin {r['plain_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    # float32: timed; float32 is no parity mode (the lam^2 = 1/u0^2 resonance
    # of the solar source), so its output must be finite and its deviation
    # from the float64 twin is printed beside the float32 twin's own
    args32 = [a.float() for a in sol_args]
    want64 = twostream.two_stream_solar_multi_weighted(*sol_args, with_amean=False)
    got32 = twostream_cuda.two_stream_solar_multi_weighted_cuda(*args32, with_amean=False)
    twin32 = twostream.two_stream_solar_multi_weighted(*args32, with_amean=False)
    dev64 = lambda xs: max(float((x.double() - w).abs().max() / w.abs().max())
                           for x, w in zip(xs[1:], want64[1:]))
    if not all(bool(torch.isfinite(x).all()) for x in got32[1:]):
        raise AssertionError("non-finite float32 solar kernel output")
    print(f"  solar float32: kernel {sol_ms(args32, False):.3f} ms (amean on "
          f"{sol_ms(args32, True):.3f} ms); largest deviation from the float64 twin over "
          f"its largest value: kernel {dev64(got32):.3e}, float32 twin {dev64(twin32):.3e}")
    del tau, w0, gt, rs, sol_args, args32, want64, got32, twin32

    # 6 and 12 zenith angles, with and without amean
    rows = 16 * nw_sol * nG
    for nzen in (6, 12):
        tau, w0, gt = _atm(gen, rows, nz, device)
        ang, zw = eqns.zenith_angles_and_weights(nzen)
        sol_args = (tau, w0, gt, torch.tensor(np.cos(ang * np.pi / 180.0), device=device),
                    0.6 * rand(rows), torch.tensor(zw, device=device), wbin)
        for am in (True, False):
            compare("two_stream_solar_multi_weighted",
                    twostream_cuda.two_stream_solar_multi_weighted_cuda(*sol_args, with_amean=am),
                    twostream.two_stream_solar_multi_weighted(*sol_args, with_amean=am))
            sync(device)
        del tau, w0, gt, sol_args

    # RORR: nk=3, R = B*nw*nz lanes (all 51 master bins), float64 at nbin 8
    # and 16, float32 at nbin 8; the sort twin runs in chunks of lanes, which
    # bounds its memory at nbin 16
    R = B * nw * nz
    for nbin in nbin_list:
        w = 0.5 + rand(nbin)
        wb = w / w.sum()
        wb_e = torch.cat([torch.zeros(1, dtype=torch.float64, device=device), torch.cumsum(wb, 0)])
        tks = 10.0 ** (-6.0 + 7.0 * rand(3, nbin, R))
        chunk = opacity._SORT_CHUNK_KEYS // (nbin * nbin)
        twin = lambda x, we: torch.cat([k_rorr_mix(x[:, :, i:i + chunk].movedim(1, -1), we)
                                        .movedim(-1, 0) for i in range(0, R, chunk)], dim=1)
        compare("k_rorr_mix", [rorr_cuda.k_rorr_mix_cuda(tks, wb, wb_e)], [twin(tks, wb_e)],
                atol=0.0)
        sync(device)
        t_kernel = event_ms(lambda: rorr_cuda.k_rorr_mix_cuda(tks, wb, wb_e), device, reps)
        t_twin = event_ms(lambda: twin(tks, wb_e), device, 1)
        work = roofline.rorr_work(R, nbin)
        bound = roofline.bound(*work)[0]
        if nbin == 8:
            r = RESULTS["k_rorr_mix"]
            r["ms"], r["plain_ms"] = t_kernel, t_twin
            set_bound("k_rorr_mix", work)
        print(f"  RORR nbin={nbin} R={R} float64: kernel {t_kernel:.3f} ms, sort twin "
              f"{t_twin:.3f} ms, bound {bound:.3f} ms")
        if nbin == 8:
            x, wb32, wb_e32 = tks.float(), wb.float(), wb_e.float()
            got, want = rorr_cuda.k_rorr_mix_cuda(x, wb32, wb_e32).double(), twin(x, wb_e32).double()
            maxrel = float((got - want).abs().max() / want.abs().max())
            if not (bool(torch.isfinite(got).all()) and maxrel < 1e-4):
                raise AssertionError(f"float32 RORR kernel deviates from its twin: {maxrel:.3e}")
            t32 = event_ms(lambda: rorr_cuda.k_rorr_mix_cuda(x, wb32, wb_e32), device, reps)
            print(f"  RORR nbin=8 R={R} float32: kernel {t32:.3f} ms, maxrel {maxrel:.3e} "
                  f"against the float32 twin")
            del x, got, want
        del tks
        torch.cuda.empty_cache()

    # a run-time nbin (not 8 or 16) at a smaller R
    nbin, R = 12, 16 * nw * nz
    w = 0.5 + rand(nbin)
    wb = w / w.sum()
    wb_e = torch.cat([torch.zeros(1, dtype=torch.float64, device=device), torch.cumsum(wb, 0)])
    tks = 10.0 ** (-6.0 + 7.0 * rand(3, nbin, R))
    compare("k_rorr_mix", [rorr_cuda.k_rorr_mix_cuda(tks, wb, wb_e)],
            [k_rorr_mix(tks.movedim(1, -1), wb_e).movedim(-1, 0)], atol=0.0)
    sync(device)
    del tks

    # float32 near-tie chain (the JAX package's shapes): stage-2 keys are sums
    # of rebinned values that cluster within a few ulps; an inexact tie-break
    # shows here as an O(pair weight) error
    nbin = 8
    wb = torch.tensor(np.polynomial.legendre.leggauss(nbin)[1] / 2.0, device=device)
    wb_e = torch.cat([torch.zeros(1, dtype=torch.float64, device=device), torch.cumsum(wb, 0)])
    wb_e[-1] = 1.0
    rng = np.random.default_rng(1)
    tks = torch.tensor(10.0 ** rng.uniform(-6, 2, (3, 64 * 202, nbin)), dtype=torch.float32,
                       device=device)
    ref = k_rorr_mix(tks, wb_e.float())
    got = rorr_cuda.k_rorr_mix_cuda(tks.movedim(-1, 1).contiguous(), wb.float(), wb_e.float()).T
    maxrel = float((got.double() - ref.double()).abs().max() / ref.double().abs().max())
    print(f"  RORR float32 near-tie chain: maxrel {maxrel:.3e} against the sort path")
    if not maxrel < 1e-4:
        raise AssertionError("float32 RORR chain deviates from the sort path")
    sync(device)
    del tks, ref, got

    # past nbin 16: opacity's sort path in lane chunks, once at the radtran
    # path's R, against the unchunked sort path on its first lanes
    nbin, R = 20, B * nw * nz
    w = 0.5 + rand(nbin)
    wb = w / w.sum()
    wb_e = torch.cat([torch.zeros(1, dtype=torch.float64, device=device), torch.cumsum(wb, 0)])
    tks = 10.0 ** (-6.0 + 7.0 * rand(3, nbin, R))
    sync(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mixed = opacity._rorr_mix(tks, wb, wb_e)
    sync(device)
    t_sort = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) - base
    if not any("nbin=20 > 16" in str(c.message) for c in caught):
        raise AssertionError("the nbin > 16 sort path gave no warning")
    chunk = opacity._SORT_CHUNK_KEYS // (nbin * nbin)
    lanes = min(R, chunk + chunk // 2)
    compare("RORR sort path in lane chunks (nbin 20)", [mixed[:, :lanes]],
            [k_rorr_mix(tks[:, :, :lanes].movedim(1, -1), wb_e).movedim(-1, 0)], rtol=1e-12,
            atol=0.0)
    print(f"  RORR nbin=20 R={R} float64, sort path in {-(-R // chunk)} chunks of {chunk} "
          f"lanes: {t_sort:.3f} ms (one call, host clock), peak device memory above its "
          f"inputs {peak / 2**30:.3f} GiB")
    del tks, mixed
    torch.cuda.empty_cache()


def _in_chunks(fn, args, rows, dim, chunk=16384):
    """fn over row chunks of the (rows, ...) arguments, outputs joined along
    ``dim`` (the row axis of each output)."""
    outs = [fn(*[a[i:i + chunk] if torch.is_tensor(a) and a.shape[:1] == (rows,) else a
                 for a in args]) for i in range(0, rows, chunk)]
    return [torch.cat([o[k] for o in outs], dim=dim[k]) for k in range(len(outs[0]))]


def phase_dispatchers(device, rows=ROOFLINE_ROWS, nz=ROOFLINE_NZ, nzen=N_ZEN, reps=5):
    print("== phase 3b: the unreduced kernels through their dispatchers, float64, "
          f"rows={rows} nz={nz}")
    gen = torch.Generator(device=device).manual_seed(2)
    rand = lambda *shape: torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    tau, w0, gt = _atm(gen, rows, nz, device)
    tau[3, 7] = 1e-7  # the thin-layer branch
    # scripts/roofline.py's IR inputs: emissivity 0.95 and the Planck
    # function at 2e13 Hz of a 290 K -> 180 K column
    emis = torch.full((rows,), 0.95, dtype=torch.float64, device=device)
    T_col = torch.linspace(290.0, 180.0, nz + 1, dtype=torch.float64, device=device)
    bpl = eqns.planck_fcn(torch.tensor(2.0e13, dtype=torch.float64, device=device),
                          T_col).expand(rows, nz + 1).contiguous()
    # zenith cosines: the template's Gauss-Legendre nodes, shared by all rows
    # for the multi-zenith kernel and cycled over the rows (one per row) for
    # the single-zenith kernel, as in a flattened (row, zenith) batch
    ang, _ = eqns.zenith_angles_and_weights(nzen)
    u0s = torch.tensor(np.cos(ang * np.pi / 180.0), device=device)
    u0 = u0s[torch.arange(rows, device=device) % nzen].contiguous()
    rs = 0.6 * rand(rows)
    wrappers = {n: KERNELS[n]["wrapper"] for n in DISPATCH_KERNELS}

    # the path: each dispatcher once, as scripts/roofline.py calls them
    for w in wrappers.values():
        w.launches = 0
    ir = {hard: twostream_cuda.two_stream_ir_auto(tau, w0, gt, emis, hard, 1e-6, bpl)
          for hard in (True, False)}
    multi = twostream_cuda.two_stream_solar_multi_auto(tau, w0, gt, u0s, rs)
    single = twostream_cuda.two_stream_solar_auto(tau, w0, gt, u0, rs)
    sync(device)
    launches = {n: w.launches for n, w in wrappers.items()}
    print(f"  kernel launches on the dispatcher path: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a dispatcher never launched its kernel: {launches}")

    for hard in (True, False):
        compare("two_stream_ir", ir[hard], _in_chunks(
            lambda *a: twostream.two_stream_ir(*a[:4], hard, 1e-6, a[4]),
            (tau, w0, gt, emis, bpl), rows, (0, 0)))
    compare("two_stream_solar_multi", multi, _in_chunks(
        lambda a, b, c, d: twostream.two_stream_solar_multi(a, b, c, u0s, d),
        (tau, w0, gt, rs), rows, (1, 1, 1, 1)))
    compare("two_stream_solar", single, _in_chunks(
        twostream.two_stream_solar, (tau, w0, gt, u0, rs), rows, (0, 0, 0, 0)))
    del ir, multi, single
    sync(device)

    # 12 zenith angles in one launch. 6 of the 12 nodes can meet the
    # lam^2 = 1/u0^2 resonance of the solar source (a fault of the
    # reference's formulation): (zenith, row) pairs with a layer within 1e-4
    # of it, relative, amplify roundoff in kernel and twin alike; they are
    # counted and must be finite, and all the others are held to the twin as
    # above
    ang12, _ = eqns.zenith_angles_and_weights(12)
    u0s12 = torch.tensor(np.cos(ang12 * np.pi / 180.0), device=device)
    n = twostream_cuda.two_stream_solar_multi_auto.launches
    multi = twostream_cuda.two_stream_solar_multi_auto(tau, w0, gt, u0s12, rs)
    sync(device)
    if twostream_cuda.two_stream_solar_multi_auto.launches - n != 1:
        raise AssertionError("12 zenith angles did not take one launch")
    twin = _in_chunks(lambda a, b, c, d: twostream.two_stream_solar_multi(a, b, c, u0s12, d),
                      (tau, w0, gt, rs), rows, (1, 1, 1, 1))
    near = resonance_distance(w0, gt, u0s12) < 1e-4
    if not all(bool(torch.isfinite(x).all()) for x in multi):
        raise AssertionError("non-finite output of the multi-zenith kernel at 12 zenith angles")
    worst = max(float(((g - w).abs() / w.abs().clamp(min=1e-300))[near].max())
                for g, w in zip(multi, twin)) if bool(near.any()) else 0.0
    print(f"  12 zenith angles: {int(near.sum())} of {near.numel()} (zenith, row) pairs "
          f"within 1e-4 of the resonance, largest relative deviation there {worst:.3e}")
    compare("two_stream_solar_multi", [g[~near] for g in multi], [w[~near] for w in twin])
    del multi, twin
    torch.cuda.empty_cache()

    timed = {
        "two_stream_ir": (lambda: twostream_cuda.two_stream_ir_auto(tau, w0, gt, emis, True, 1e-6, bpl),
                          lambda: twostream.two_stream_ir(tau, w0, gt, emis, True, 1e-6, bpl)),
        "two_stream_solar_multi": (
            lambda: twostream_cuda.two_stream_solar_multi_auto(tau, w0, gt, u0s, rs),
            lambda: twostream.two_stream_solar_multi(tau, w0, gt, u0s, rs)),
        "two_stream_solar": (lambda: twostream_cuda.two_stream_solar_auto(tau, w0, gt, u0, rs),
                             lambda: twostream.two_stream_solar(tau, w0, gt, u0, rs)),
    }
    set_bound("two_stream_ir", roofline.ir_work(rows, nz))
    set_bound("two_stream_solar_multi", roofline.solar_multi_work(rows, nz, nzen))
    set_bound("two_stream_solar", roofline.solar_work(rows, nz))
    for name, (kernel, twin) in timed.items():
        r = RESULTS[name]
        r["ms"] = event_ms(kernel, device, reps)
        r["plain_ms"] = event_ms(twin, device, 2)
        torch.cuda.empty_cache()
        print(f"  {name}: kernel {r['ms']:.3f} ms, twin {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    ms12 = event_ms(lambda: twostream_cuda.two_stream_solar_multi_auto(tau, w0, gt, u0s12, rs),
                    device, reps)
    bound12 = roofline.bound(*roofline.solar_multi_work(rows, nz, 12))[0]
    torch.cuda.empty_cache()
    print(f"  two_stream_solar_multi at 12 zenith angles (one launch): kernel {ms12:.3f} ms, "
          f"bound {bound12:.3f} ms")
    return launches


def resonance_distance(w0, gt, u0s):
    """(nzen, rows): the least |lam^2 - 1/u0^2| * u0^2 over each row's layers,
    lam of the delta-scaled layer (the solar source divides by lam^2 - 1/u0^2)."""
    g2 = gt * gt
    w0s, gs = w0 * (1.0 - g2) / (1.0 - w0 * g2), gt / (1.0 + gt)
    gam1 = 3.0**0.5 * (2.0 - w0s * (1.0 + gs)) / 2.0
    gam2 = 3.0**0.5 * w0s * (1.0 - gs) / 2.0
    lam2 = gam1 * gam1 - gam2 * gam2
    return torch.stack([((lam2 - 1.0 / u**2).abs() * u**2).amin(dim=1) for u in u0s])


def bench_inputs(sp, B, nz, device, seed=0):
    """The bench.py column batch: an Earth-like prescribed column, jittered."""
    zc = np.linspace(0.0, 7.0e6, nz)
    T = np.maximum(288.0 - 6.5e-5 * zc, 200.0)
    dz = np.full(nz, 7.0e6 / nz)
    P_bar = 1.013 * np.exp(-zc / 8.0e5)
    den = P_bar * 1.0e6 / (1.380649e-16 * T)
    mix = np.full((nz, sp.ng), 1e-12)
    mix[:, sp.gas_names.index("H2O")] = 1e-2 * np.exp(-zc / 2e5) + 1e-6
    mix[:, sp.gas_names.index("CO2")] = 400e-6
    mix[:, sp.gas_names.index("N2")] = 0.78
    dens = mix * den[:, None]
    rng = np.random.default_rng(seed)
    T_surf_b = rng.uniform(280.0, 295.0, B)
    jitter = rng.uniform(0.95, 1.05, (B, 1))
    t = lambda x: torch.tensor(x, dtype=torch.float64, device=device)
    column = (T, P_bar, dens, dz)
    batch = (t(T_surf_b), t(T[None, :] * jitter), t(np.repeat(P_bar[None, :], B, axis=0)),
             t(dens[None, :, :] * jitter[:, :, None]), t(np.repeat(dz[None, :], B, axis=0)))
    return column, batch


def _rorr_twin(tau_ks_t, wbin, wbin_e):
    return k_rorr_mix(tau_ks_t.movedim(1, -1), wbin_e).movedim(-1, 0)


@contextlib.contextmanager
def twin_path():
    """Swap the radtran path's three kernel wrappers for their plain twins."""
    with mock.patch.object(opacity, "k_rorr_mix_cuda", _rorr_twin), \
            mock.patch.object(radiate, "two_stream_ir_weighted_cuda",
                              twostream.two_stream_ir_weighted), \
            mock.patch.object(radiate, "two_stream_solar_multi_weighted_cuda",
                              twostream.two_stream_solar_multi_weighted):
        yield


TWINS = {"two_stream_ir_weighted": (twostream.two_stream_ir_weighted, ("fup", "fdn")),
         "two_stream_solar_multi_weighted": (twostream.two_stream_solar_multi_weighted,
                                             ("amean", "fup", "fdn")),
         "k_rorr_mix": (_rorr_twin, ("tau",))}


def recorder(last, name, wrapper):
    """``wrapper`` that keeps its last inputs at each shape in ``last`` under
    (name, rows or lanes)."""
    def run(tau, *args, **kwargs):
        n = tau.shape[-1] if name == "k_rorr_mix" else tau.shape[0]
        last[(name, n)] = (wrapper, (tau, *args), kwargs)
        return wrapper(tau, *args, **kwargs)
    return run


def check_against_twins(last, launches, path):
    """Each kernel against its twin on the inputs recorded in ``last`` (by
    :func:`recorder`), every output at RTOL with ATOL capped at 1e-10 of its
    largest value (the IR outputs are ~1e-8 in the model's units, where ATOL
    alone would pass a 1e-4 relative error); fails unless the kernel side
    launched each of the three kernels again."""
    for (name, n), (wrapper, args, kwargs) in sorted(last.items()):
        twin, outputs = TWINS[name]
        got, want = wrapper(*args, **kwargs), twin(*args, **kwargs)
        if torch.is_tensor(got):
            got, want = [got], [want]
        for output, g, w in zip(outputs, got, want):
            if w is None:
                continue
            scale = float(w.abs().max())
            print(f"  {name} {output} at {n} rows/lanes: largest value {scale:.3e}")
            compare(f"{name} {output} at {n} rows/lanes of {path} (kernel vs twin)",
                    [g], [w], atol=min(ATOL, 1e-10 * scale))
        del got, want
    checked = _launches(RADTRAN_KERNELS)
    if any(checked[k] == launches[k] for k in RADTRAN_KERNELS):
        raise AssertionError(f"the kernel side of the twin comparisons did not launch every "
                             f"kernel: {launches} -> {checked}")


@contextlib.contextmanager
def recording(last):
    """The radtran path's three kernel wrappers, each through :func:`recorder`."""
    with mock.patch.object(opacity, "k_rorr_mix_cuda",
                           recorder(last, "k_rorr_mix", rorr_cuda.k_rorr_mix_cuda)), \
            mock.patch.object(radiate, "two_stream_ir_weighted_cuda", recorder(
                last, "two_stream_ir_weighted", twostream_cuda.two_stream_ir_weighted_cuda)), \
            mock.patch.object(radiate, "two_stream_solar_multi_weighted_cuda", recorder(
                last, "two_stream_solar_multi_weighted",
                twostream_cuda.two_stream_solar_multi_weighted_cuda)):
        yield


def _reset(names):
    for name in names:
        KERNELS[name]["wrapper"].launches = 0


def _launches(names):
    return {name: KERNELS[name]["wrapper"].launches for name in names}


def make_radiate_many(rad, K):
    """bench.py's K distinct evaluations of the batched RT chain; returns the
    summed (ISR, OLR), each (B,)."""
    op = rad.op
    ir_slice = (rad.ir.ind_start, rad.ir.ind_end)
    sol_slice = (rad.sol.ind_start, rad.sol.ind_end)
    dev, dt = rad.device, rad.dtype
    t = lambda x: torch.tensor(np.asarray(x), dtype=dt, device=dev)
    emis, alb = t(np.ones(rad.ir.nw)), t(np.full(rad.sol.nw, 0.25))
    photons, zen_u, zw = t(rad.photons_sol), t(rad.zenith_u), t(rad.zenith_weights)

    def radiate_one(T_surf, T, P, dens, dz):
        opr = opacity.compute_opacity(op, P, T, dens, dz)
        r_ir = radiate.radiate_ir(ir_slice, op.freq, op.kset.wbin, opr, emis, True, 1e-6,
                                  T_surf, T)
        fup_ir, fdn_ir = radiate.integrate_fluxes(r_ir["fup_a"], r_ir["fdn_a"],
                                                  op.freq[ir_slice[0]:ir_slice[1] + 2])
        r_sol = radiate.radiate_solar(sol_slice, op.freq, op.wavl, op.kset.wbin, opr, alb,
                                      0.5, photons, zen_u, zw, compute_amean=False)
        fup_sol, fdn_sol = radiate.integrate_fluxes(r_sol["fup_a"], r_sol["fdn_a"],
                                                    op.freq[sol_slice[0]:sol_slice[1] + 2])
        return fdn_sol[:, -1] - fup_sol[:, -1], -(fdn_ir[:, -1] - fup_ir[:, -1])

    def radiate_many(T_surf, T, P, dens, dz):
        acc_isr, acc_olr = 0.0, 0.0
        for i in range(K):
            s = 1.0 + 1e-6 * i
            isr, olr = radiate_one(T_surf * s, T * s, P, dens * s, dz)
            acc_isr, acc_olr = acc_isr + isr, acc_olr + olr
        return acc_isr, acc_olr

    return radiate_many


def phase_radtran_path(device, B=B_COLS, K=K_INNER, nz_template=NZ_TEMPLATE, reps=5):
    print("== phase 4: the radtran path")
    nz = 2 * nz_template + 2
    tpl = make_template(nz=nz_template, n_zenith=N_ZEN)
    sp = species_from_dict(tpl["species"])
    column, batch = bench_inputs(sp, B, nz, device)
    _reset(RADTRAN_KERNELS)
    torch.cuda.reset_peak_memory_stats(device)

    # the facade on one column, then the bench-shaped batch, through the kernels
    rad = Radtran(sp.gas_names, [], tpl["settings"], tpl["star"], N_ZEN, 0.25, nz,
                  tpl["datadir"])
    assert rad.device.type == "cuda"
    isr1, olr1 = rad.TOA_fluxes(290.0, *column)
    fup_sol = rad.wrk_sol.fup_n
    radiate_many = make_radiate_many(rad, K)
    isr, olr = radiate_many(*batch)
    sync(device)
    launches = _launches(RADTRAN_KERNELS)
    peak = torch.cuda.max_memory_allocated(device)
    print(f"  Radtran one column: ISR {isr1:.6f} OLR {olr1:.6f} mW/m^2; "
          f"wrk_sol.fup_n shape {fup_sol.shape}")
    print(f"  batch B={B} K={K} nz_r={nz}: ISR mean {float(isr.mean()) / K:.6f} "
          f"OLR mean {float(olr.mean()) / K:.6f} mW/m^2")
    print(f"  kernel launches on the radtran path: {launches}")
    print(f"  peak device memory: {peak / 2**30:.3f} GiB")
    if not (np.isfinite([isr1, olr1]).all() and bool(torch.isfinite(isr).all())
            and bool(torch.isfinite(olr).all())):
        raise AssertionError("non-finite TOA fluxes")
    if isr.shape != (B,) or olr.shape != (B,) or fup_sol.shape != (nz + 1,):
        raise AssertionError("unexpected output shapes")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the radtran path never launched: {launches}")

    # the same column and batch through the plain twins
    rad_cpu = Radtran(sp.gas_names, [], tpl["settings"], tpl["star"], N_ZEN, 0.25, nz,
                      tpl["datadir"], device="cpu")
    isr1_p, olr1_p = rad_cpu.TOA_fluxes(290.0, *column)
    compare("Radtran.TOA_fluxes (card vs CPU twins)",
            [torch.tensor([isr1, olr1], dtype=torch.float64)],
            [torch.tensor([isr1_p, olr1_p], dtype=torch.float64)], atol=0.0)

    def radiate_many_plain(*args):
        with twin_path():
            return radiate_many(*args)

    isr_p, olr_p = radiate_many_plain(*batch)
    if _launches(RADTRAN_KERNELS) != launches:
        raise AssertionError("the twin path launched a kernel")
    compare("batch ISR/OLR (kernel vs twin path)", [isr, olr], [isr_p, olr_p], atol=0.0)

    t_kernel = median_ms(lambda: radiate_many(*batch), device, reps, warmup=1)
    t_plain = median_ms(lambda: radiate_many_plain(*batch), device, 3, warmup=1)
    solves = (rad.ir.nw * rad.op.kset.nbin + rad.sol.nw * rad.op.kset.nbin * N_ZEN) * B * K
    print(f"  batch time (median of {reps}): kernel path {t_kernel:.3f} ms, "
          f"plain path (median of 3) {t_plain:.3f} ms")
    print(f"  two-stream solves/s: kernel path {solves / (t_kernel / 1e3):.6e}, "
          f"plain path {solves / (t_plain / 1e3):.6e} ({solves} solves per batch)")

    # where one batch's device time goes, by kernel (torch.profiler)
    times = device_ms_by_kernel(lambda: radiate_many(*batch), device)
    busy = sum(times.values())
    if busy == 0.0:
        print("  profiler: no device time recorded (not measured)")
    else:
        groups = {"RORR": ("rorr_chain",),
                  "two-stream": ("solar_weighted_kernel", "ir_weighted_kernel")}
        shares = {g: sum(ms for name, ms in times.items() if any(k in name for k in keys))
                  for g, keys in groups.items()}
        shares["other"] = busy - sum(shares.values())
        for label, key in (("weighted solar", "solar_weighted_kernel"),
                           ("weighted IR", "ir_weighted_kernel")):
            shares[f"of which {label}"] = sum(ms for name, ms in times.items() if key in name)
        print(f"  profiler, one batch: device busy {busy:.3f} ms in {len(times)} kernel "
              f"names; " + ", ".join(f"{g} {ms:.3f} ms ({100 * ms / busy:.1f} %)"
                                     for g, ms in shares.items()))
    return launches


def device_ms_by_kernel(fn, device):
    """Device time in ms of each kernel name in one run of fn, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(device)
    times = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            times[evt.name] += evt.time_range.elapsed_us() / 1e3
    return times


def entry_batch(c, B=ENTRY_B):
    """__graft_entry__.entry's inputs: T_surf linspace(270, 300, B) and
    __graft_entry__._p_batch's partial pressures."""
    P_i = np.full((B, c.sp.ng), 1.0e-15)
    P_i[:, c.species_names.index("H2O")] = 270.0e6
    P_i[:, c.species_names.index("CO2")] = np.linspace(200.0, 800.0, B)
    P_i[:, c.species_names.index("N2")] = 1.0e6
    return np.linspace(270.0, 300.0, B), P_i


@functools.lru_cache(maxsize=None)
def _entry_model(device):
    """The entry workload's model, built once per process and device (phases
    5 and 10 share the card's)."""
    tpl = make_template(nz=ENTRY_NZ, n_zenith=N_ZEN)
    return AdiabatClimate(tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"],
                          device=device)


def _cpu_surface_temperature(conn):
    """Child process: the surface_temperature solve of the entry batch's
    first column by the port on the CPU; sends (T_surf, seconds, error)."""
    try:
        torch.set_num_threads(2)
        c = _entry_model("cpu")
        _, P_i = entry_batch(c)
        t0 = time.perf_counter()
        conn.send((c.surface_temperature(P_i[0], T_guess=280.0), time.perf_counter() - t0, None))
    except Exception as e:  # reported to the parent, which raises
        conn.send((None, None, repr(e)))
    finally:
        conn.close()


def march_ops_per_profile(c, T_surf, P_i, nz):
    """Eager tensor operations of one make_profile_core call on these columns,
    counted with a dispatch counter on the CPU at nz=2 and nz=3 and
    extrapolated to ``nz`` (the march's count is exactly linear in the number
    of intervals)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    counts = []
    for n in (2, 3):
        par = adiabat_profile.AdiabatParams.from_species(
            c.sp, n, c.planet_mass, c.planet_radius, c.P_top, c.substeps, "cpu")
        Count.n = 0
        with Count():
            adiabat_profile.make_profile_core(par, torch.ones(c.sp.ng, dtype=torch.float64),
                                              torch.tensor(T_surf), torch.tensor(P_i),
                                              float(c.T_trop))
        counts.append(Count.n)
    return counts[0] + (counts[1] - counts[0]) * (nz - 2)


def path_bounds(c, B, B_ir=None):
    """The bound in ms of each of the three kernels of model ``c``'s radiate
    call over B columns (the IR kernel over B_ir columns when given), from
    ``tools/roofline.py``'s counts."""
    nz_r, nG, nw_ir, nw_sol, nw = c.nz_r, c.rad.op.kset.nbin, c.rad.ir.nw, c.rad.sol.nw, c.rad.op.nw
    nzen = len(c.rad.zenith_u)
    rows_ir, rows_sol, R = (B_ir or B) * nw_ir * nG, B * nw_sol * nG, B * nw * nz_r
    work = {"two_stream_ir_weighted": roofline.ir_weighted_work(rows_ir, nz_r, nG),
            "two_stream_solar_multi_weighted": roofline.solar_weighted_work(rows_sol, nz_r, nzen,
                                                                            nG),
            "k_rorr_mix": roofline.rorr_work(R, nG, len(c.rad.op.k))}
    return {name: roofline.bound(*w)[0] for name, w in work.items()}


def phase_adiabat_path(device, smi):
    print(f"== phase 5: the adiabat path (__graft_entry__.entry: B={ENTRY_B}, nz={ENTRY_NZ}, "
          f"{N_ZEN} zenith angles)")
    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe(duplex=False)
    child = ctx.Process(target=_cpu_surface_temperature, args=(child_conn,))
    child.start()
    child_conn.close()
    try:
        return _adiabat_on_card(device, smi, parent_conn)
    finally:
        child.join(timeout=900)
        if child.is_alive():
            child.terminate()
            child.join()
            raise AssertionError("the CPU surface_temperature solve did not finish in 900 s")


def _adiabat_on_card(device, smi, conn):
    c = _entry_model(None)
    assert c.device.type == "cuda"
    T_np, P_np = entry_batch(c)
    T_surf = torch.tensor(T_np, device=device)
    P_i = torch.tensor(P_np, device=device)
    fns = make_column_fns(c)

    torch.cuda.reset_peak_memory_stats(device)
    _reset(RADTRAN_KERNELS)
    t0 = time.perf_counter()
    isr, olr = fns["toa_fluxes"](T_surf, P_i)
    sync(device)
    first_s = time.perf_counter() - t0
    UNSHARDED["toa"] = (isr.cpu().numpy(), olr.cpu().numpy())
    launches = _launches(RADTRAN_KERNELS)
    print(f"  first toa_fluxes batch: {first_s:.2f} s; CUDA graph capture seconds "
          f"{dict((k, round(v, 3)) for k, v in CAPTURE_SECONDS.items())}")
    print(f"  ISR {isr.cpu().numpy()} mW/m^2")
    print(f"  OLR {olr.cpu().numpy()} mW/m^2")
    print(f"  kernel launches on the adiabat path (one batch): {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the adiabat path never launched: {launches}")
    if isr.shape != (ENTRY_B,) or not (bool(torch.isfinite(isr).all())
                                       and bool(torch.isfinite(olr).all())):
        raise AssertionError("non-finite or misshapen TOA fluxes")

    with twin_path():
        isr_p, olr_p = fns["toa_fluxes"](T_surf, P_i)
    if _launches(RADTRAN_KERNELS) != launches:
        raise AssertionError("the twin path launched a kernel")
    compare("entry ISR/OLR (kernel vs twin path)", [isr, olr], [isr_p, olr_p], atol=0.0)

    batch_ms = median_ms(lambda: fns["toa_fluxes"](T_surf, P_i), device, reps=10, warmup=1)
    peak = torch.cuda.max_memory_allocated(device)
    print(f"  toa_fluxes batch time (median of 10, {smi}): {batch_ms:.3f} ms; "
          f"peak device memory {peak / 2**30:.3f} GiB")

    # the three kernels at this path's shapes: CUDA events around each
    # wrapper call of one batch, beside each one's bound at these shapes
    events = []

    def timed(name, wrapper):
        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = wrapper(*args, **kwargs)
            end.record()
            events.append((name, start, end))
            return out
        return run

    with mock.patch.object(opacity, "k_rorr_mix_cuda", timed("k_rorr_mix", rorr_cuda.k_rorr_mix_cuda)), \
            mock.patch.object(radiate, "two_stream_ir_weighted_cuda", timed(
                "two_stream_ir_weighted", twostream_cuda.two_stream_ir_weighted_cuda)), \
            mock.patch.object(radiate, "two_stream_solar_multi_weighted_cuda", timed(
                "two_stream_solar_multi_weighted", twostream_cuda.two_stream_solar_multi_weighted_cuda)):
        fns["toa_fluxes"](T_surf, P_i)
    sync(device)
    path_ms = {name: start.elapsed_time(end) for name, start, end in events}
    bounds = path_bounds(c, ENTRY_B)
    for name, bound in bounds.items():
        print(f"  {name} at this path's shapes: {path_ms[name]:.4f} ms (CUDA events around the "
              f"wrapper call), bound {bound:.4f} ms")

    # the march alone: its time with the interval graph and eagerly
    RH = torch.ones(c.sp.ng, dtype=torch.float64, device=device)
    profile = lambda: adiabat_profile.make_profile_core(c._par, RH, T_surf, P_i, float(c.T_trop))
    profile_ms = median_ms(profile, device, reps=3, warmup=1)
    eager = lambda fn, *args: (fn, fn(*args))  # graphed() replaced by plain calls
    with mock.patch.object(adiabat_profile, "graphed", eager):
        eager_ms = median_ms(profile, device, reps=1, warmup=0)
    ops = march_ops_per_profile(c, T_np, P_np, ENTRY_NZ)
    print(f"  one profile (B={ENTRY_B}, {2 * ENTRY_NZ} intervals x {c.substeps} substeps): "
          f"{profile_ms:.3f} ms with the interval graph, {eager_ms:.3f} ms eager; "
          f"{ops} tensor operations (CPU dispatch count)")

    # one surface_temperature solve on the card, against the CPU port's
    evals = collections.Counter()
    toa = c.TOA_fluxes

    def counted(*args):
        evals["toa"] += 1
        return toa(*args)

    c.TOA_fluxes = counted
    t0 = time.perf_counter()
    try:
        T_card = c.surface_temperature(P_np[0], T_guess=280.0)
    finally:
        del c.TOA_fluxes  # the model is phase 10's too
    solve_s = time.perf_counter() - t0
    print(f"  surface_temperature on the card: {T_card:.10f} K in {solve_s:.2f} s, "
          f"{evals['toa']} TOA_fluxes evaluations")
    T_cpu, cpu_s, err = conn.recv()
    if err is not None:
        raise AssertionError(f"the CPU surface_temperature solve failed: {err}")
    print(f"  surface_temperature by the port on the CPU: {T_cpu:.10f} K in {cpu_s:.2f} s")
    rel = abs(T_card - T_cpu) / abs(T_cpu)
    print(f"  card vs CPU: relative difference {rel:.3e}")
    if not rel <= 1e-8:
        raise AssertionError("surface_temperature on the card disagrees with the CPU port")
    return launches


def _rce_model(device, nz=RCE_NZ):
    tpl = make_template(nz=nz, n_zenith=N_ZEN, surface_albedo=0.3)
    c = AdiabatClimate(tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"],
                       substeps=RCE_SUBSTEPS, device=device)
    c.verbose = False
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0
    P_i[c.species_names.index("N2")] = 1.0e6
    return c, P_i


def _fluxes(c):
    """The objective's flux state: f_total at the physical edges, each
    channel's net flux profile and per-bin fluxes, host float64."""
    w_ir, w_sol = c.rad.wrk_ir, c.rad.wrk_sol
    return dict(f_total=rce._f_total_edges_precise(c), ir_net=w_ir.fdn_n - w_ir.fup_n,
                sol_net=w_sol.fdn_n - w_sol.fup_n, ir_fup_a=w_ir.fup_a, ir_fdn_a=w_ir.fdn_a,
                sol_fup_a=w_sol.fup_a, sol_fdn_a=w_sol.fdn_a)


def _cpu_rce_objective(conn):
    """Child process: the port on the CPU. Receives the card's final RCE state
    (mask, T_surf, T, x, P_i), rebuilds make_profile_rc and the objective at
    it, and sends back (state, fluxes, error)."""
    try:
        torch.set_num_threads(2)
        c, _ = _rce_model("cpu")
        mask, T_surf, T, x, P_i = conn.recv()
        c._set_convecting_zones(mask)
        c.T_surf, c.T = T_surf, T
        rce._objective(c, P_i, x)
        state = {k: getattr(c, k) for k in ("P", "T", "z", "lapse_rate", "lapse_rate_intended")}
        conn.send((state, _fluxes(c), None))
    except EOFError:  # the card's side ended before sending its state
        pass
    except Exception as e:  # reported to the parent, which raises
        conn.send((None, None, repr(e)))
    finally:
        conn.close()


def compare_fluxes(name, got, want):
    """Flux arrays (host or device) at rtol 1e-9 and an atol of 1e-10 of
    each array's largest value: near the top of the column the downward IR
    flux and the net flux f_total fall to ~xtol_rc of the flux scale, where
    the float64 roundoff of sums over ~10^5-sized terms (~1e-13 of the
    scale) exceeds rtol 1e-9 of the entry. 1e-10 of the scale is ~1e-5
    mW/m^2 at these fluxes, 1e5 times below the residual RCE converges to."""
    for k in got:
        g, w = torch.as_tensor(got[k]).cpu(), torch.as_tensor(want[k]).cpu()
        compare(f"{name} {k}", [g], [w], atol=1e-10 * float(w.abs().max()))


def phase_rce_path(device, smi):
    print(f"== phase 6: the RCE path (AdiabatClimate.RCE: nz={RCE_NZ}, substeps={RCE_SUBSTEPS}, "
          f"{N_ZEN} zenith angles, float64)")
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=_cpu_rce_objective, args=(child_conn,))
    child.start()
    child_conn.close()
    try:
        return _rce_on_card(device, smi, conn)
    finally:
        conn.close()
        child.join(timeout=600)
        if child.is_alive():
            child.terminate()
            child.join()
            raise AssertionError("the CPU objective evaluation did not finish in 600 s")


def _rce_on_card(device, smi, conn):
    t_phase = time.perf_counter()
    c, P_i = _rce_model(None)
    assert c.device.type == "cuda"
    t0 = time.perf_counter()
    T_warm = c.surface_temperature(P_i, T_guess=280.0)
    T_guess = c.T.copy()
    print(f"  warm start: surface_temperature {T_warm:.10f} K in {time.perf_counter() - t0:.2f} s")

    # instrumentation: counts and host-clock seconds of the path's parts
    # (each closed by a device sync), and CUDA events around each kernel call
    counts, secs, modes, calls, last = collections.Counter(), collections.Counter(), [], [], {}

    def counted(name, fn):
        def run(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return run

    def timed(name, fn):
        def run(*args, **kwargs):
            sync(device)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            secs[name] += time.perf_counter() - t
            return out
        return run

    def update(self, P_i_surf, T_in, mode):
        modes.append(mode)
        return update_zones(self, P_i_surf, T_in, mode)

    def evented(name, wrapper):
        def run(tau, *args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = wrapper(tau, *args, **kwargs)
            end.record()
            n = tau.shape[-1] if name == "k_rorr_mix" else tau.shape[0]
            calls.append((name, n, start, end))
            last[(name, n)] = (wrapper, (tau, *args), kwargs)
            return out
        return run

    update_zones = rce._update_convecting_zones
    captures0 = dict(CAPTURES)
    torch.cuda.reset_peak_memory_stats(device)
    _reset(RADTRAN_KERNELS)
    t0 = time.perf_counter()
    with mock.patch.object(rce, "_objective", counted("evaluations", rce._objective)), \
            mock.patch.object(rce, "_jacobian_from_base",
                              counted("jacobians", rce._jacobian_from_base)), \
            mock.patch.object(rce, "_update_convecting_zones", update), \
            mock.patch.object(rce, "make_profile_rc_core",
                              timed("march", rce.make_profile_rc_core)), \
            mock.patch.object(c.rad, "radiate", timed("radiate", c.rad.radiate)), \
            mock.patch.object(c.rad, "ir_fluxes_batch",
                              timed("jacobian IR batch", c.rad.ir_fluxes_batch)), \
            mock.patch.object(opacity, "k_rorr_mix_cuda",
                              evented("k_rorr_mix", rorr_cuda.k_rorr_mix_cuda)), \
            mock.patch.object(radiate, "two_stream_ir_weighted_cuda", evented(
                "two_stream_ir_weighted", twostream_cuda.two_stream_ir_weighted_cuda)), \
            mock.patch.object(radiate, "two_stream_solar_multi_weighted_cuda", evented(
                "two_stream_solar_multi_weighted",
                twostream_cuda.two_stream_solar_multi_weighted_cuda)):
        converged = c.RCE(P_i, T_warm, c.T.copy())
    sync(device)
    rce_s = time.perf_counter() - t0
    # the warm start and the solution, for phase 8
    solved = dict(model=c, P_i=P_i, T_warm=T_warm, T_guess=T_guess,
                  mask=c.convecting_with_below.copy(), T_surf=c.T_surf, T=c.T.copy())
    launches = _launches(RADTRAN_KERNELS)
    peak = torch.cuda.max_memory_allocated(device)
    captured = {k: v - captures0.get(k, 0) for k, v in CAPTURES.items()
                if v != captures0.get(k, 0)}
    host_s = rce_s - sum(secs.values())
    print(f"  converged {converged}; mode iterations {modes}; {counts['evaluations']} objective "
          f"evaluations, {counts['jacobians']} Jacobians; final mask "
          f"{''.join(str(int(v)) for v in c.convecting_with_below)}")
    print(f"  T_surf {c.T_surf:.10f} K; RCE {rce_s:.2f} s ({smi}): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()) + f", host rest {host_s:.2f} s; "
          f"graph captures {captured}; peak device memory {peak / 2**30:.3f} GiB")
    rows = collections.defaultdict(list)
    for name, n, start, end in calls:
        rows[(name, n)].append(start.elapsed_time(end))
    ir_rows = max(n for name, n in rows if name == "two_stream_ir_weighted")
    print(f"  kernel launches on the RCE path: {launches}; #1's largest row count {ir_rows}")
    nG, nw_ir = c.rad.op.kset.nbin, c.rad.ir.nw
    for (name, n), ms in sorted(rows.items()):
        B_ir = n // (nw_ir * nG) if name == "two_stream_ir_weighted" else None
        bound = path_bounds(c, 1, B_ir)[name]
        wrapper, args, kwargs = last[(name, n)]
        kernel_ms = event_ms(lambda: wrapper(*args, **kwargs), device, reps=20)
        print(f"  {name} at {n} rows/lanes: {len(ms)} calls in the path, mean "
              f"{statistics.mean(ms):.4f} ms (CUDA events around each wrapper call); "
              f"{kernel_ms:.4f} ms a call back to back (20 calls); bound {bound:.6f} ms")
    if not converged:
        raise AssertionError("RCE did not converge on the card")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the RCE path never launched: {launches}")
    if captured.get("_rc_interval") != 1:
        raise AssertionError(f"the RC interval graph was not captured exactly once: {captured}")
    if not (np.isfinite(c.T).all() and np.isfinite(c.T_surf)):
        raise AssertionError("non-finite RCE temperatures")

    # the final state through the kernels and through their twins
    T_in = np.concatenate([[c.T_surf], c.T])
    rce._objective_fixed_profile(c, T_in, True, True)
    on_card = _fluxes(c)
    with twin_path():
        rce._objective_fixed_profile(c, T_in, True, True)
    compare_fluxes("RCE objective (kernel vs twin path)", on_card, _fluxes(c))
    x = np.array([T_in[ind - 1] for ind in c._inds_Tx])
    _, T_perts, _ = rce._perturbation_matrix(c, x)
    batch = (T_perts[:, 0], rce._radiative_grid(T_perts[:, 1:]))
    got = c.rad.ir_fluxes_batch(*batch)
    with twin_path():
        want = c.rad.ir_fluxes_batch(*batch)
    compare_fluxes(f"RCE Jacobian IR batch, {len(x)} columns (kernel vs twin path)",
                   dict(fup_n=got[0], fdn_n=got[1]), dict(fup_n=want[0], fdn_n=want[1]))
    if _launches(RADTRAN_KERNELS) == launches:
        raise AssertionError("the kernel side of the twin comparisons launched no kernel")

    # the card's final state rebuilt by the port on the CPU
    conn.send((c.convecting_with_below, c.T_surf, c.T, x, P_i))
    rce._objective(c, P_i, x)
    state, fluxes, err = conn.recv()
    if err is not None:
        raise AssertionError(f"the CPU objective evaluation failed: {err}")
    compare("RCE final state P, T, z, lapse rates (card vs CPU port)",
            [torch.tensor(getattr(c, k)) for k in state], [torch.tensor(v) for v in state.values()],
            atol=0.0)
    compare_fluxes("RCE objective (card vs CPU port)", _fluxes(c), fluxes)
    print(f"  phase 6: {time.perf_counter() - t_phase:.1f} s")
    return launches, solved


@functools.lru_cache(maxsize=None)
def _solver_model(device):
    """Phase 7's model: the entry workload's template at SOLVER_NZ layers."""
    tpl = make_template(nz=SOLVER_NZ, n_zenith=N_ZEN)
    return AdiabatClimate(tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"],
                          device=device)


def _cpu_column_at(conn):
    """Child process: the port on the CPU. Builds phase 7's model, receives
    the card's solution (T_surf, P_i_surf) and the targets N, evaluates
    column_model and profile_only there and sends (ISR, OLR, N from each,
    the residual norm, seconds, error)."""
    try:
        torch.set_num_threads(2)
        c = _solver_model("cpu")
        fns = make_column_fns(c)
        T_surf, P_i, N_target = (torch.tensor(a) for a in conn.recv())
        t0 = time.perf_counter()
        m = fns["column_model"](T_surf, P_i, float(c.T_trop))
        only = fns["profile_only"](T_surf, P_i, float(c.T_trop))
        fnorm = column_residual_norm(m, N_target, float(c.surface_heat_flow))
        conn.send((dict(ISR=m["ISR"].numpy(), OLR=m["OLR"].numpy(),
                        N=(m["N_atmos"] + m["N_surface"]).numpy(),
                        N_profile_only=(only["N_atmos"] + only["N_surface"]).numpy()),
                   fnorm.numpy(), time.perf_counter() - t0, None))
    except EOFError:  # the card's side ended before sending its solution
        pass
    except Exception as e:  # reported to the parent, which raises
        conn.send((None, None, None, repr(e)))
    finally:
        conn.close()


def column_residual_norm(m, N_target, surface_heat_flow):
    """max |r / s| per column of batched_surface_temperature_column's joint
    system: energy balance over max(|ISR|, 1), N - N_target over |N_target|."""
    r_e = (m["ISR"] - m["OLR"] + surface_heat_flow).abs() / m["ISR"].abs().clamp(min=1.0)
    r_n = (m["N_atmos"] + m["N_surface"] - N_target).abs() / N_target.abs().clamp(min=1e-30)
    return torch.maximum(r_e, r_n.amax(dim=1))


def phase_solver_path(device, smi):
    print(f"== phase 7: the batched solver path (batched_surface_temperature_column: "
          f"B={ENTRY_B}, nz={SOLVER_NZ}, {N_ZEN} zenith angles, float64)")
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=_cpu_column_at, args=(child_conn,))
    child.start()
    child_conn.close()
    try:
        return _solver_on_card(device, smi, conn)
    finally:
        conn.close()
        child.join(timeout=600)
        if child.is_alive():
            child.terminate()
            child.join()
            raise AssertionError("the CPU column evaluation did not finish in 600 s")


def _solver_on_card(device, smi, conn):
    t_phase = time.perf_counter()
    c = _solver_model(None)
    assert c.device.type == "cuda"
    T_np, P_np = entry_batch(c)
    fns = make_column_fns(c)
    T_trop, tol = float(c.T_trop), 1.0e-8
    only = fns["profile_only"](torch.tensor(T_np, device=device),
                               torch.tensor(P_np, device=device), T_trop)
    N_target = only["N_atmos"] + only["N_surface"]  # the solve's only input

    # instrumentation: each column_model call's column count and host-clock
    # seconds (closed by a device sync), CUDA events around each kernel call
    calls, last = [], {}

    def counted_fns(model):
        out = make_column_fns(model)
        column_model = out["column_model"]

        def run(T_surf, P_i, T_trop):
            t = time.perf_counter()
            m = column_model(T_surf, P_i, T_trop)
            sync(device)
            calls.append((T_surf.shape[0], time.perf_counter() - t))
            return m
        return dict(out, column_model=run)

    captures0, capture_s0 = dict(CAPTURES), dict(CAPTURE_SECONDS)
    torch.cuda.reset_peak_memory_stats(device)
    _reset(RADTRAN_KERNELS)
    t0 = time.perf_counter()
    with mock.patch.object(solvers, "make_column_fns", counted_fns), \
            recording(last):
        out = solvers.batched_surface_temperature_column(c, N_target, T_guess=280.0, tol=tol)
    sync(device)
    solve_s = time.perf_counter() - t0
    launches = _launches(RADTRAN_KERNELS)
    peak = torch.cuda.max_memory_allocated(device)
    captured = {k: v - captures0.get(k, 0) for k, v in CAPTURES.items()
                if v != captures0.get(k, 0)}
    capture_s = {k: round(v - capture_s0.get(k, 0.0), 3) for k, v in CAPTURE_SECONDS.items()
                 if k in captured}
    T_sol, P_sol, status = out["T_surf"], out["P_i_surf"], out["status"]
    model_s = sum(sec for _, sec in calls)
    print(f"  T_surf {T_sol.cpu().numpy()} K")
    print(f"  status {status.cpu().numpy()}, fnorm {out['fnorm'].cpu().numpy()}")
    print(f"  solve {solve_s:.2f} s ({smi}): {len(calls)} column_model calls, {model_s:.2f} s "
          f"in them, the rest {solve_s - model_s:.2f} s; columns per call "
          f"{[n for n, _ in calls]}; seconds per call {[round(sec, 2) for _, sec in calls]}")
    print(f"  graph captures {captured}, capture seconds {capture_s}; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    print(f"  kernel launches on the solver path: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the solver path never launched: {launches}")
    if not bool((status == 0).all()):
        raise AssertionError(f"a lane of the batched solve did not converge: {status}")

    # the CPU port evaluates the solution while the card goes on
    conn.send(tuple(a.cpu().numpy() for a in (T_sol, P_sol, N_target)))

    # each kernel against its twin on the last inputs the solve gave it at
    # each of its shapes (the solution's, the Jacobian's, the line search's
    # and the floor's column counts)
    check_against_twins(last, launches, "the solver path")

    # the three kernels at the line search's shape (the largest call)
    n_cols = max(n for n, _ in calls)
    nG, nw_ir, nw_sol = c.rad.op.kset.nbin, c.rad.ir.nw, c.rad.sol.nw
    shape = {"two_stream_ir_weighted": n_cols * nw_ir * nG,
             "two_stream_solar_multi_weighted": n_cols * nw_sol * nG,
             "k_rorr_mix": n_cols * c.rad.op.nw * c.nz_r}
    bounds = path_bounds(c, n_cols)
    for name, n in shape.items():
        wrapper, args, kwargs = last[(name, n)]
        kernel_ms = event_ms(lambda: wrapper(*args, **kwargs), device, reps=20)
        print(f"  {name} at {n} rows/lanes ({n_cols} columns): {kernel_ms:.4f} ms a call back "
              f"to back (20 calls, CUDA events), bound {bounds[name]:.4f} ms")

    # the solution through the kernels and through their twins
    m = fns["column_model"](T_sol, P_sol, T_trop)
    with twin_path():
        m_p = fns["column_model"](T_sol, P_sol, T_trop)
    compare("solver path ISR/OLR at the solution (kernel vs twin path)",
            [m["ISR"], m["OLR"]], [m_p["ISR"], m_p["OLR"]], atol=0.0)
    fnorm = column_residual_norm(m, N_target, float(c.surface_heat_flow))
    print(f"  residual norm at the solution on the card: {fnorm.cpu().numpy()}")

    # the solution evaluated by the port on the CPU
    cpu, fnorm_cpu, cpu_s, err = conn.recv()
    if err is not None:
        raise AssertionError(f"the CPU column evaluation failed: {err}")
    print(f"  CPU port at the solution: {cpu_s:.2f} s; residual norm {fnorm_cpu}")
    N_card = (m["N_atmos"] + m["N_surface"]).cpu()
    only = fns["profile_only"](T_sol, P_sol, T_trop)
    compare("solver path ISR, OLR, N, profile_only N at the solution (card vs CPU port)",
            [m["ISR"].cpu(), m["OLR"].cpu(), N_card, (only["N_atmos"] + only["N_surface"]).cpu()],
            [torch.tensor(cpu[k]) for k in ("ISR", "OLR", "N", "N_profile_only")],
            rtol=1e-8, atol=0.0)
    if not bool((torch.tensor(fnorm_cpu) < 2.0 * tol).all()):
        raise AssertionError(f"the CPU port's residual norm at the card's solution is not "
                             f"below 2 tol: {fnorm_cpu}")
    print(f"  phase 7: {time.perf_counter() - t_phase:.1f} s")
    return launches


DEVICE_RCE_CO2 = (200.0, 400.0, 800.0, 1600.0)  # scripts/rce_bench.py:101's spread, 4 lanes


def _device_rce_lanes(c, P_i):
    P_i_b = np.repeat(P_i[None], len(DEVICE_RCE_CO2), axis=0)
    P_i_b[:, c.species_names.index("CO2")] = DEVICE_RCE_CO2
    return P_i_b


def _cpu_device_rce_rebuild(conn):
    """Child process: the port on the CPU. Receives the card's final
    device-RCE state (x (B, nz+1), masks (B, nz), P_i (B, ng)), evaluates the
    device RCE objective there and sends (state, max|F/F0| per lane,
    seconds, error)."""
    try:
        torch.set_num_threads(2)
        c, _ = _rce_model("cpu")
        x, mask, P_i = (torch.tensor(a) for a in conn.recv())
        t0 = time.perf_counter()
        xm, dFdt, _, aux = rce_device.build_rce_fns(c)["objective"](x, mask, P_i)
        char = max(abs(c.rad.bolometric_flux() / 4.0 + c.surface_heat_flow * 1.0e-3), 1.0e-6)
        ratio = dFdt.abs().amax(dim=1) * 1.0e-3 / char
        state = dict(T=xm[:, 1:], P=aux["P_c"], z=aux["z"], lr_actual=aux["lr_actual"],
                     lr_intended=aux["lr_intended"], f_total=aux["f_total"])
        conn.send(({k: v.numpy() for k, v in state.items()}, ratio.numpy(),
                   time.perf_counter() - t0, None))
    except EOFError:  # the card's side ended before sending its state
        pass
    except Exception as e:  # reported to the parent, which raises
        conn.send((None, None, None, repr(e)))
    finally:
        conn.close()


def phase_device_rce_path(device, smi, rce_state):
    print(f"== phase 8: the device RCE path (rce_device.batched_rce: B={len(DEVICE_RCE_CO2)} "
          f"lanes, CO2 {DEVICE_RCE_CO2} dyn/cm^2, nz={RCE_NZ}, substeps={RCE_SUBSTEPS}, "
          f"{N_ZEN} zenith angles, float64)")
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=_cpu_device_rce_rebuild, args=(child_conn,))
    child.start()
    child_conn.close()
    try:
        return _device_rce_on_card(device, smi, conn, rce_state)
    finally:
        conn.close()
        child.join(timeout=600)
        if child.is_alive():
            child.terminate()
            child.join()
            raise AssertionError("the CPU rebuild of the device RCE did not finish in 600 s")


def _device_rce_on_card(device, smi, conn, st):
    t_phase = time.perf_counter()
    c, P_i = st["model"], st["P_i"]
    P_i_b = _device_rce_lanes(c, P_i)
    B = P_i_b.shape[0]

    # instrumentation: host-clock seconds of the path's parts (each closed
    # by a device sync), the march's batch sizes, and each kernel's last
    # inputs at each of its shapes
    secs, counts, marches, last = (collections.Counter(), collections.Counter(),
                                   collections.Counter(), {})

    def timed(name, fn, count=None):
        def run(*args, **kwargs):
            if count is not None:
                count(*args)
            sync(device)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            secs[name] += time.perf_counter() - t
            return out
        return run

    radiate_ir = rce_device.radiate_ir

    def ir(*args, **kwargs):
        # the Jacobian's IR batch has B (n+1) columns, an objective's B or 2B
        T_surface = args[-2]
        name = "Jacobian IR batch" if T_surface.shape[0] > 2 * B else "radiative transfer"
        counts[name] += 1
        return timed(name, radiate_ir)(*args, **kwargs)

    captures0 = dict(CAPTURES)
    torch.cuda.reset_peak_memory_stats(device)
    _reset(RADTRAN_KERNELS)
    t0 = time.perf_counter()
    with mock.patch.object(rce_device, "make_profile_rc_core", timed(
                "march", rce_device.make_profile_rc_core,
                lambda *a: marches.update([a[2].shape[0]]))), \
            mock.patch.object(rce_device, "compute_altitude_core",
                              timed("altitude", rce_device.compute_altitude_core)), \
            mock.patch.object(rce_device, "compute_opacity", timed(
                "radiative transfer", rce_device.compute_opacity,
                lambda *a: counts.update(["objective evaluations"]))), \
            mock.patch.object(rce_device, "radiate_ir", ir), \
            mock.patch.object(rce_device, "radiate_solar",
                              timed("radiative transfer", rce_device.radiate_solar)), \
            recording(last):
        out = rce_device.batched_rce(c, P_i_b, np.full(B, st["T_warm"]),
                                     np.repeat(st["T_guess"][None], B, axis=0))
    sync(device)
    total_s = time.perf_counter() - t0
    launches = _launches(RADTRAN_KERNELS)
    peak = torch.cuda.max_memory_allocated(device)
    captured = {k: v - captures0.get(k, 0) for k, v in CAPTURES.items()
                if v != captures0.get(k, 0)}
    host_s = total_s - sum(secs.values())
    h = {k: out[k].cpu().numpy() for k in ("T_surf", "T", "convecting_with_below", "converged",
                                            "status", "rc_iters", "solve_iters", "max_ratio",
                                            "ratio_floor")}
    for b in range(B):
        print(f"  lane {b} (CO2 {DEVICE_RCE_CO2[b]}): status {h['status'][b]}, outer iterations "
              f"{h['rc_iters'][b]}, solve iterations {h['solve_iters'][b]}, T_surf "
              f"{h['T_surf'][b]:.10f} K, max|F/F0| {h['max_ratio'][b]:.3e}, ratio_floor "
              f"{h['ratio_floor'][b]:.3e}, mask "
              f"{''.join(str(int(v)) for v in h['convecting_with_below'][b])}")
    print(f"  batched_rce {total_s:.2f} s ({smi}): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()) + f", host rest {host_s:.2f} s")
    print(f"  {counts['objective evaluations']} objective evaluations, "
          f"{counts['Jacobian IR batch']} Jacobian IR batches; marches by batch size "
          f"{dict(marches)}; graph captures {captured}; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    print(f"  kernel launches on the device RCE path: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the device RCE path never launched: {launches}")
    if not ((h["status"] == 0).all() and (h["max_ratio"] < c.xtol_rc).all()):
        raise AssertionError(f"a lane of the device RCE did not converge: {h['status']}")

    # the CPU port rebuilds the final state while the card goes on
    x = torch.cat([out["T_surf"][:, None], out["T"]], dim=1)
    conn.send((x.cpu().numpy(), h["convecting_with_below"], P_i_b))

    # lane 1 is phase 6's column: against its host RCE
    dT_surf = h["T_surf"][1] - st["T_surf"]
    dT = np.abs(h["T"][1] - st["T"]).max()
    print(f"  lane 1 against phase 6's host RCE: T_surf gap {dT_surf:.3e} K, max |dT| "
          f"{dT:.3e} K, masks equal {bool((h['convecting_with_below'][1] == st['mask']).all())}")
    if not (h["convecting_with_below"][1] == st["mask"]).all():
        raise AssertionError("lane 1's mask differs from the host RCE's")
    if not (abs(dT_surf) < 0.5 and dT < 2.0):
        raise AssertionError("lane 1 is outside the host RCE's limits (0.5 K, 2 K)")

    # each kernel against its twin on the last inputs the path gave it at
    # each of its shapes (the B-lane objective, the 2B-lane probe, the
    # Jacobian batch)
    check_against_twins(last, launches, "the device RCE path")

    # each kernel at the path's largest shape, back to back
    nG, nw_ir, nw_sol, nw = c.rad.op.kset.nbin, c.rad.ir.nw, c.rad.sol.nw, c.rad.op.nw
    per_column = {"two_stream_ir_weighted": nw_ir * nG,
                  "two_stream_solar_multi_weighted": nw_sol * nG, "k_rorr_mix": nw * c.nz_r}
    for name, k in per_column.items():
        n = max(m for kernel, m in last if kernel == name)
        wrapper, args, kwargs = last[(name, n)]
        kernel_ms = event_ms(lambda: wrapper(*args, **kwargs), device, reps=20)
        cols = n // k
        bound = path_bounds(c, cols, cols)[name]
        print(f"  {name} at {n} rows/lanes ({cols} columns): {kernel_ms:.4f} ms a call back to "
              f"back (20 calls, CUDA events), bound {bound:.4f} ms")

    # the card's objective at the final state against the CPU port's
    xm, _, _, aux = rce_device.build_rce_fns(c)["objective"](
        x, out["convecting_with_below"], c._tensor(P_i_b))
    card = dict(T=xm[:, 1:], P=aux["P_c"], z=aux["z"], lr_actual=aux["lr_actual"],
                lr_intended=aux["lr_intended"])
    state, ratio_cpu, cpu_s, err = conn.recv()
    if err is not None:
        raise AssertionError(f"the CPU rebuild of the device RCE failed: {err}")
    print(f"  CPU port at the card's final state: {cpu_s:.2f} s; max|F/F0| {ratio_cpu}")
    compare("device RCE final T, P, z, lapse rates (card vs CPU port)",
            [v.cpu() for v in card.values()], [torch.tensor(state[k]) for k in card],
            atol=0.0)
    compare_fluxes("device RCE f_total (card vs CPU port)", dict(f_total=aux["f_total"]),
                   dict(f_total=state["f_total"]))
    if not (ratio_cpu < c.xtol_rc).all():
        raise AssertionError(f"the CPU port's max|F/F0| at the card's state is not below "
                             f"xtol_rc: {ratio_cpu}")
    print(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")
    return launches

CLIMATE_NZ = 50  # ModernEarth's 50 layers; nz_r = 100 (no ghost layers)
CLIMATE_T_EVAL = np.logspace(4.0, 6.0, 10)  # examples/climate_evolve.py:92
# the integrators' (rtol, atol) for the checked pair of runs. At the
# model's default (1e-4, 1e-6), and for DOP853 still at 1e-6, the two take
# different paths through the convective onset near 4e5 s, where the RHS is
# not smooth (eddy_for_heat's regimes), and part by up to ~0.25 K there; at
# 1e-7 both stay within ~1e-3 K of each other, and take fewer steps
# (fewer rejected at the stability limit) than at the default
CLIMATE_TIGHT = (1.0e-7, 1.0e-9)
# the flux roundoff that dT/dt is held to across devices, as a share of the
# largest channel flux (see climate_tendency_atol)
CLIMATE_EPS_FLUX = 1e-12


def _climate_model(device, atmosphere):
    """Phase 9's model: tests/test_climate.py's settings and atmosphere
    column; species, star and data from the in-memory template."""
    tpl = make_template(nz=CLIMATE_NZ, n_zenith=N_ZEN)
    text = climate_settings_yaml_text(nz=CLIMATE_NZ, n_zenith=N_ZEN)
    settings = settings_from_dict(yaml.safe_load(text), "<climate settings>")
    c = Climate(tpl["species"], settings, tpl["star"], atmosphere, tpl["datadir"],
                device=device)
    c.verbose = False
    return c


def _climate_at(c, states):
    """right_hand_side at each state (n, neq), the hydrostatic pressure
    frozen at T_init, and fluxes_fn over all states in one call; host
    float64."""
    c._P = None
    c.right_hand_side(c.T_init)
    dTdt = np.stack([c.right_hand_side(y) for y in states])
    _, fluxes_fn = c._build_device_fns(T_freeze=c.T_init)
    y = c._t(states)
    return dTdt, [a.cpu().numpy() for a in fluxes_fn(y[:, 0], y[:, 1:])]


def climate_tendency_atol(c, states, fluxes):
    """Per entry of dT/dt at each state, the tendency that a flux error of
    CLIMATE_EPS_FLUX of the state's largest channel flux would make: twice
    that error (dF/dz takes two edges) over the layer's rho * cp * dz, or the
    ground slab's. The fluxes of the kernels and of their CPU twins differ
    by ~1e-14 of that scale; dT/dt = dF/dz / (rho cp) amplifies it by
    1 / (rho cp dz), most in the thin top layers."""
    col = c._column()
    T = c._t(states[:, 1:])
    cp = torch.sum(heat_capacity(col["thermo"], T) * col["mix"], dim=-1) \
        * (1.0 / (col["mubar"] * 1.0e-3)) * 1.0e4
    rho = c._t(c._density) * (1.0 / constants.N_avo) * col["mubar"]
    per_volume = torch.cat([torch.full_like(cp[:, :1], RHO_GROUND * CP_GROUND * DZ_GROUND),
                            rho * cp * col["dz"]], dim=1)
    F = np.max([np.abs(a).max(axis=1) for a in fluxes[1:]], axis=0)
    return 2.0 * CLIMATE_EPS_FLUX * torch.tensor(F)[:, None] / per_volume.cpu()


def _cpu_climate_at(conn):
    """Child process: the port on the CPU. Receives the atmosphere file and
    builds phase 9's model, then receives the card's snapshot states and
    sends back (dT/dt, fluxes, seconds, error) from :func:`_climate_at`."""
    try:
        torch.set_num_threads(2)
        c = _climate_model("cpu", conn.recv())
        states = conn.recv()
        t0 = time.perf_counter()
        dTdt, fluxes = _climate_at(c, states)
        conn.send((dTdt, fluxes, time.perf_counter() - t0, None))
    except EOFError:  # the card's side ended before sending its states
        pass
    except Exception as e:  # reported to the parent, which raises
        conn.send((None, None, None, repr(e)))
    finally:
        conn.close()


@contextlib.contextmanager
def no_twins():
    """The three kernels' plain twins raise if anything calls them."""
    def refuse(name):
        def run(*args, **kwargs):
            raise AssertionError(f"the twin {name} ran on the card's path")
        return run

    with mock.patch.object(twostream, "two_stream_ir_weighted",
                           refuse("two_stream_ir_weighted")), \
            mock.patch.object(twostream, "two_stream_solar_multi_weighted",
                              refuse("two_stream_solar_multi_weighted")), \
            mock.patch.object(rorr_cuda, "k_rorr_mix", refuse("k_rorr_mix")):
        yield


def phase_climate_path(device, smi):
    print(f"== phase 9: the Climate path (Climate.evolve, DOP853 and rk45_device: "
          f"nz={CLIMATE_NZ}, {N_ZEN} zenith angles, t_eval {len(CLIMATE_T_EVAL)} times "
          f"log-spaced {CLIMATE_T_EVAL[0]:g}-{CLIMATE_T_EVAL[-1]:g} s, float64)")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_climate_")
    atmosphere = os.path.join(workdir, "atmosphere.txt")
    write_atmosphere_file(atmosphere)
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=_cpu_climate_at, args=(child_conn,))
    child.start()
    child_conn.close()
    try:
        conn.send(atmosphere)
        return _climate_on_card(device, smi, conn, atmosphere, workdir)
    finally:
        conn.close()
        child.join(timeout=600)
        shutil.rmtree(workdir, ignore_errors=True)
        if child.is_alive():
            child.terminate()
            child.join()
            raise AssertionError("the CPU evaluation of the Climate RHS did not finish in 600 s")


def _climate_on_card(device, smi, conn, atmosphere, workdir):
    t_phase = time.perf_counter()
    c = _climate_model(None, atmosphere)
    assert c.device.type == "cuda"
    print(f"  model built in {time.perf_counter() - t_phase:.2f} s: nz {c.nz}, nz_r {c.nz_r}, "
          f"{c.rad.ir.nw} IR + {c.rad.sol.nw} solar bins, {c.rad.op.kset.nbin} gauss points")

    # both integrators at CLIMATE_TIGHT, held to each other, then evolve's
    # defaults (DOP853 at the model's tolerances), whose gap is reported
    defaults = (c.rtol, c.atol)
    runs = [(method, CLIMATE_TIGHT) for method in ("DOP853", "rk45_device")]
    runs.append(("DOP853", defaults))
    last, streams = {}, {}
    torch.cuda.reset_peak_memory_stats(device)
    _reset(RADTRAN_KERNELS)
    for method, (rtol, atol) in runs:
        before = _launches(RADTRAN_KERNELS)
        fn = os.path.join(workdir, f"{method}_{rtol}.npz")
        c.rtol, c.atol = rtol, atol
        sync(device)
        t0 = time.perf_counter()
        with recording(last), no_twins():
            ok = c.evolve(fn, 0.0, c.T_init, CLIMATE_T_EVAL, overwrite=True, method=method)
        sync(device)
        secs = time.perf_counter() - t0
        st = c.evolve_stats
        added = {k: v - before[k] for k, v in _launches(RADTRAN_KERNELS).items()}
        print(f"  {method} at rtol {rtol:g}, atol {atol:g}: success {ok}, "
              f"{st['rhs_evaluations']} RHS evaluations, {st['attempted']} steps attempted, "
              f"{st['accepted']} accepted, {st['rejected']} rejected; {secs:.3f} s ({smi}), "
              f"{1e3 * secs / st['rhs_evaluations']:.3f} ms per RHS; kernel launches {added}")
        if not ok:
            raise AssertionError(f"Climate.evolve({method!r}) did not succeed on the card")
        if min(added.values()) < 1:
            raise AssertionError(f"a kernel of the Climate path never launched in {method}: "
                                 f"{added}")
        streams[(method, rtol)] = load_evolve_file(fn)
    c.rtol, c.atol = defaults
    launches = _launches(RADTRAN_KERNELS)
    peak = torch.cuda.max_memory_allocated(device)
    print(f"  kernel launches on the Climate path: {launches}; peak device memory "
          f"{peak / 2**30:.3f} GiB")

    n_t, neq = len(CLIMATE_T_EVAL), c.neq
    for (method, rtol), out in streams.items():
        for k, v in out.items():
            if not np.isfinite(v).all():
                raise AssertionError(f"{method} at rtol {rtol:g}: non-finite {k}")
        if out["T"].shape != (n_t, neq) or out["f_total"].shape != (n_t, c.nz + 1):
            raise AssertionError(f"{method} at rtol {rtol:g}: unexpected snapshot shapes")
    host, dev = (streams[(m, CLIMATE_TIGHT[0])]["T"] for m in ("DOP853", "rk45_device"))
    print(f"  T_surf(t) {np.array2string(host[:, 0], precision=4)} K; max |T(t_end) - T(0)| "
          f"{np.abs(host[-1] - host[0]).max():.4f} K")
    gap = np.abs(streams[("DOP853", defaults[0])]["T"] - host).max(axis=1)
    print(f"  DOP853 at the default tolerances against DOP853 at rtol {CLIMATE_TIGHT[0]:g}: "
          f"max |dT| per snapshot {np.array2string(gap, precision=3)} K")
    compare(f"Climate snapshot T at rtol {CLIMATE_TIGHT[0]:g} (rk45_device vs DOP853)",
            [torch.tensor(dev)], [torch.tensor(host)], rtol=1e-4, atol=1e-3)

    # an RHS split into radiative transfer and the rest, on the card, before
    # the CPU child starts to compete for the host
    rhs, fluxes_fn = c._build_device_fns()
    y = c._t(c.T_init)
    rhs_ms = median_ms(lambda: rhs(y), device, reps=20)
    rt_ms = median_ms(lambda: fluxes_fn(y[None, 0], y[None, 1:]), device, reps=20)
    host_ms = median_ms(lambda: c.right_hand_side(c.T_init), device, reps=20)
    print(f"  one device RHS {rhs_ms:.3f} ms (median of 20, {smi}): radiative transfer "
          f"{rt_ms:.3f} ms ({100 * rt_ms / rhs_ms:.1f} %), the rest {rhs_ms - rt_ms:.3f} ms; "
          f"one host right_hand_side (through the Radtran facade) {host_ms:.3f} ms")
    times = device_ms_by_kernel(lambda: rhs(y), device)
    busy = sum(times.values())
    kernels = {name: sum(ms for k, ms in times.items() if key in k)
               for name, key in (("#1", "ir_weighted_kernel"), ("#2", "solar_weighted_kernel"),
                                 ("RORR", "rorr_chain"))}
    print(f"  profiler, one device RHS: device busy {busy:.3f} ms in {len(times)} kernel names "
          f"(idle {100 * (1 - busy / rhs_ms):.1f} % of the median RHS); "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in kernels.items())
          + f", the rest {busy - sum(kernels.values()):.3f} ms")

    # the CPU port evaluates the RHS and fluxes at the last three snapshots
    # while the card goes on
    states = dev[-3:]
    conn.send(states)

    # each kernel against its twin on the last inputs the path gave it, and
    # its time and bound at each of the path's shapes
    check_against_twins(last, launches, "the Climate path")
    nG, nw_ir, nw_sol, nw = c.rad.op.kset.nbin, c.rad.ir.nw, c.rad.sol.nw, c.rad.op.nw
    per_column = {"two_stream_ir_weighted": nw_ir * nG,
                  "two_stream_solar_multi_weighted": nw_sol * nG, "k_rorr_mix": nw * c.nz_r}
    for (name, n), (wrapper, args, kwargs) in sorted(last.items()):
        cols = n // per_column[name]
        kernel_ms = event_ms(lambda: wrapper(*args, **kwargs), device, reps=20)
        bound = path_bounds(c, cols)[name]
        print(f"  {name} at {n} rows/lanes ({cols} columns): {kernel_ms:.4f} ms a call back to "
              f"back (20 calls, CUDA events), bound {bound:.6f} ms")

    # the card's RHS and fluxes at those states against the CPU port's
    dTdt, fluxes = _climate_at(c, states)
    dTdt_cpu, fluxes_cpu, cpu_s, err = conn.recv()
    if err is not None:
        raise AssertionError(f"the CPU evaluation of the Climate RHS failed: {err}")
    print(f"  CPU port at the card's last 3 snapshots: {cpu_s:.2f} s; card vs CPU dT/dt: "
          f"max |diff| {np.abs(dTdt - dTdt_cpu).max():.3e} K/s, "
          f"{np.abs(dTdt - dTdt_cpu).max() / np.abs(dTdt_cpu).max():.3e} of the largest")
    atol = climate_tendency_atol(c, states, fluxes_cpu)
    compare("Climate right_hand_side (card vs CPU port, per-layer flux-roundoff atol)",
            [torch.tensor(dTdt)], [torch.tensor(dTdt_cpu)], atol=atol)
    for name, g, w in zip(("f_total", "fup_ir", "fdn_ir", "fup_sol", "fdn_sol"), fluxes,
                          fluxes_cpu):
        compare(f"Climate fluxes_fn {name} over 3 snapshots (card vs CPU port)",
                [torch.tensor(g)], [torch.tensor(w)], rtol=0.0, atol=1e-9 * np.abs(w).max())
    print(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _free_port():
    with contextlib.closing(socket.socket()) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _gap(got, want):
    """(largest relative difference, bitwise equal)."""
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    return float(rel.max()), bool(np.array_equal(got, want))


def phase_sharded_path(smi):
    print(f"== phase 10: the sharded path (mesh=make_mesh(); two gloo ranks sharing the card: "
          f"batched_toa_fluxes B={ENTRY_B}, nz={ENTRY_NZ}, and batched_rce "
          f"B={len(DEVICE_RCE_CO2)}, nz={SHARDED_RCE_NZ}; one NCCL rank: batched_toa_fluxes)")
    t_phase = time.perf_counter()
    T_np, P_np = entry_batch(_entry_model(None))
    c, P_i = _rce_model(None, nz=SHARDED_RCE_NZ)
    T_warm = c.surface_temperature(P_i, T_guess=280.0)
    P_i_b = _device_rce_lanes(c, P_i)
    B = P_i_b.shape[0]
    rce_args = (P_i_b, np.full(B, T_warm), np.repeat(c.T[None], B, axis=0))
    print(f"  nz={SHARDED_RCE_NZ} warm start: surface_temperature {T_warm:.10f} K")
    toa = ("toa", dict(nz=ENTRY_NZ, n_zenith=N_ZEN), parallel.batched_toa_fluxes, (T_np, P_np),
           {})
    rce_call = ("rce", dict(nz=SHARDED_RCE_NZ, n_zenith=N_ZEN, surface_albedo=0.3,
                            substeps=RCE_SUBSTEPS), rce_device.batched_rce, rce_args, {})
    workdirs = {name: tempfile.mkdtemp(prefix=f"chip_smoke_{name}_") for name in ("gloo", "nccl")}
    ctxs = {}
    try:
        ctxs["gloo"] = distributed_worker.start(2, [toa, rce_call], workdirs["gloo"],
                                                backend="gloo",
                                                coordinator=f"127.0.0.1:{_free_port()}",
                                                threads=2)
        # the NCCL rank finds its rendezvous in the environment
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        ctxs["nccl"] = distributed_worker.start(1, [toa], workdirs["nccl"], threads=2)
        # the unsharded RCE lanes, on the card here while the ranks work
        t0 = time.perf_counter()
        want = rce_device.batched_rce(c, *rce_args)
        sync(c.device)
        print(f"  unsharded batched_rce (B={B}, nz={SHARDED_RCE_NZ}): "
              f"{time.perf_counter() - t0:.2f} s")
        want = {k: v.cpu().numpy() for k, v in want.items() if torch.is_tensor(v)}
        outs = {}
        for name, ctx in ctxs.items():
            for rank, out in enumerate(distributed_worker.join(ctx, workdirs[name], 600)):
                outs[f"{name} rank {rank}"] = out
    finally:
        for ctx in ctxs.values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        for d in workdirs.values():
            shutil.rmtree(d, ignore_errors=True)

    launches = dict.fromkeys(RADTRAN_KERNELS, 0)
    for label, out in outs.items():
        for call, (_, seconds, counts) in out.items():
            print(f"  {label} of {2 if label.startswith('gloo') else 1}, {call}: "
                  f"{seconds:.2f} s, kernel launches {counts}")
            if min(counts.values()) < 1:
                raise AssertionError(f"a kernel of the sharded path never launched on {label}, "
                                     f"{call}: {counts}")
            for k, n in counts.items():
                launches[k] += n

    r0, r1 = outs["gloo rank 0"], outs["gloo rank 1"]
    (toa0, _, _), (toa1, _, _) = r0["toa"], r1["toa"]
    (rce0, _, _), (rce1, _, _) = r0["rce"], r1["rce"]
    same = all(np.array_equal(a, b) for a, b in zip(toa0, toa1)) and set(rce0) == set(rce1) \
        and all(np.array_equal(rce0[k], rce1[k]) for k in want)
    if not same:
        raise AssertionError("the two gloo ranks gathered different results")
    print(f"  the two gloo ranks hold the same gathered TOA fluxes and RCE lanes")
    for i, name in enumerate(("ISR", "OLR")):
        gap, bitwise = _gap(toa0[i], UNSHARDED["toa"][i])
        print(f"  {name} (B={ENTRY_B}, two gloo ranks) against phase 5: largest relative gap "
              f"{gap:.3e}, bitwise {bitwise}")
        if not gap <= 1e-12:
            raise AssertionError(f"sharded {name} outside rtol 1e-12 of phase 5's")
    one = outs["nccl rank 0"]["toa"][0]
    for i, name in enumerate(("ISR", "OLR")):
        gap, bitwise = _gap(one[i], UNSHARDED["toa"][i])
        print(f"  {name} (one NCCL rank) against phase 5: largest relative gap {gap:.3e}, "
              f"bitwise {bitwise}")
        if not bitwise:
            raise AssertionError(f"the one-rank mesh's {name} differs from phase 5's")
    print(f"  RCE lanes: status {rce0['status']}, outer iterations {rce0['rc_iters']}, "
          f"solve iterations {rce0['solve_iters']} (unsharded: {want['rc_iters']}, "
          f"{want['solve_iters']})")
    if not ((rce0["status"] == 0).all() and rce0["converged"].all()
            and (want["status"] == 0).all()):
        raise AssertionError(f"an RCE lane did not converge: sharded {rce0['status']}, "
                             f"unsharded {want['status']}")
    if not np.array_equal(rce0["convecting_with_below"], want["convecting_with_below"]):
        raise AssertionError("the sharded RCE's masks differ from the unsharded ones")
    for k in ("T_surf", "T"):
        gap, bitwise = _gap(rce0[k], want[k])
        print(f"  RCE {k} (two gloo ranks) against unsharded: largest relative gap {gap:.3e}, "
              f"bitwise {bitwise}")
        if not gap <= 1e-7:
            raise AssertionError(f"sharded RCE {k} outside rtol 1e-7 of the unsharded")
    print(f"  kernel launches on the sharded path (every rank): {launches}")
    print(f"  phase 10: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


EXAMPLES = {"modern_earth_radtran": modern_earth_radtran,
            "tutorial_adiabat_climate": tutorial_adiabat_climate,
            "early_mars": early_mars, "climate_evolve": climate_evolve}


def _check_example(name, out):
    """Raise unless the example's numbers are finite, what it reports as
    converged did converge, and the files it wrote read back."""
    finite = lambda *xs: all(bool(np.isfinite(np.asarray(x, dtype=np.float64)).all()) for x in xs)
    if name == "modern_earth_radtran":  # main itself asserts the custom-opacity round trip
        with np.load(out["spectra_file"]) as d:
            ok = finite(out["toa_solar_fdn"], out["olr"], out["f_total"], out["f_total_custom"],
                        out["f_total_restored"], *(d[k] for k in d.files))
    elif name == "tutorial_adiabat_climate":
        atm = AtmosphereFile(out["atmosphere_file"])
        ok = (out["converged"] and finite(out["ISR"], out["OLR"], out["T_surf"], out["T"])
              and atm.nz == len(out["T"]) and finite(*atm.columns.values()))
    elif name == "early_mars":
        # the batched damped Newton (the JAX package's, 30 steps) leaves some
        # CO2-rich columns unconverged, its result then their last iterate:
        # every column finite, the thin-CO2 ones converged
        ok = finite(out["T_surf"], out["residual"]) and bool(out["converged"][:3].all())
    else:
        snaps = load_evolve_file(out["evolve_file"])
        ok = (out["converged"] and len(snaps["t"]) == len(climate_evolve.T_EVAL)
              and finite(*snaps.values()))
    if not ok:
        raise AssertionError(f"the {name} example gave non-finite, unconverged or unreadable "
                             f"results")


def _recorded_main(name, last, **kwargs):
    """One example's ``main()`` with the kernels' inputs kept in ``last``
    (:func:`recording`) and the twins refused (:func:`no_twins`)."""
    with recording(last), no_twins():
        return EXAMPLES[name].main(**kwargs)


def _example_in_child(conn, name, root):
    """Child process: one example's ``main()`` on the card, then each kernel
    against its twin on the inputs the example gave it; sends (its result,
    the kernels' launches in main(), seconds, what main() printed, what the
    twin comparisons printed, error)."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _reset(KERNELS)
        printed, checked, last = io.StringIO(), io.StringIO(), {}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            out = _recorded_main(name, last, root=root)
        torch.cuda.synchronize()
        seconds, n = time.perf_counter() - t0, _launches(KERNELS)
        with contextlib.redirect_stdout(checked):
            check_against_twins(last, n, f"the {name} example")
        conn.send((out, n, seconds, printed.getvalue(), checked.getvalue(), None))
    except Exception as e:  # reported to the parent, which raises
        conn.send((None, None, None, None, None, repr(e)))
    finally:
        conn.close()


def start_examples(names, workdir):
    """Start each example in a process of its own on the card, writing under
    ``workdir``; returns {name: (process, its pipe)}."""
    ctx, children = multiprocessing.get_context("spawn"), {}
    for name in names:
        root = os.path.join(workdir, name)
        os.makedirs(root)
        conn, child_conn = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_example_in_child, args=(child_conn, name, root))
        proc.start()
        child_conn.close()
        children[name] = (proc, conn)
    return children


# the examples that run each in a process of its own on the card, beside
# the rest (their solves are host-bound launches, as is the rest):
# early_mars (~200 s) from phase 10's start, tutorial_adiabat_climate from
# phase 11's
EARLY_EXAMPLES = ("early_mars",)
CHILD_EXAMPLES = EARLY_EXAMPLES + ("tutorial_adiabat_climate",)


def phase_examples_and_tools(device, smi, workdir, children):
    """``children``: the examples of EARLY_EXAMPLES, started before phase 10
    by :func:`start_examples` under ``workdir``; the phase adds its own."""
    print("== phase 11: the four examples at their own sizes and the four tools, each once")
    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)

    def counted(label, fn, *args, **kwargs):
        """(fn's result, its launches by this process's wrappers, added to the
        phase's, and what it printed, shown only where it raises)."""
        _reset(KERNELS)
        sync(device)
        t0 = time.perf_counter()
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                out = fn(*args, **kwargs)
        except BaseException:
            print(printed.getvalue())
            raise
        sync(device)
        n = _launches(KERNELS)
        for k, v in n.items():
            launches[k] += v
        print(f"  {label}: {time.perf_counter() - t0:.1f} s, kernel launches "
              f"{ {k: v for k, v in n.items() if v} }", flush=True)
        return out, n, printed.getvalue()

    def example_done(name, out, n, printed):
        print("    " + "\n    ".join(printed.splitlines()[-8:]))
        if min(n[k] for k in RADTRAN_KERNELS) < 1:
            raise AssertionError(f"the {name} example did not launch each of #1, #2 and RORR: {n}")
        _check_example(name, out)

    # started first, to run beside the rest: the CPU reference of the
    # validation tool's device RCE, and the examples of CHILD_EXAMPLES not
    # yet started, each in a process of its own
    reference = validation.start_reference(8)
    try:
        children.update(start_examples([n for n in CHILD_EXAMPLES if n not in children],
                                       workdir))
        for name in EXAMPLES:
            if name not in CHILD_EXAMPLES:
                root = os.path.join(workdir, name)
                os.makedirs(root)
                last = {}
                out, n, printed = counted(f"examples.{name}.main()", _recorded_main, name,
                                          last, root=root)
                example_done(name, out, n, printed)
                # each kernel against its twin at each shape the example gave it
                check_against_twins(last, n, f"the {name} example")
                del last
        phase_tools(device, counted, launches, reference)
    finally:  # validation.main stops and removes it; here only where it never ran
        if reference.proc.poll() is None:
            reference.proc.kill()
            reference.proc.wait()
        shutil.rmtree(os.path.dirname(reference.path), ignore_errors=True)
    for name, (_, conn) in children.items():
        out, n, seconds, printed, checked, err = conn.recv()
        if err is not None:
            raise AssertionError(f"the {name} example failed in its process: {err}")
        for k, v in n.items():
            launches[k] += v
        when = "phase 10's" if name in EARLY_EXAMPLES else "the phase's"
        print(f"  examples.{name}.main() (a process of its own, from {when} start): "
              f"{seconds:.1f} s, kernel launches { {k: v for k, v in n.items() if v} }")
        example_done(name, out, n, printed)
        print(checked, end="")
    print(f"  kernel launches on phase 11's paths: {launches}")
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


def phase_tools(device, counted, launches, reference):
    """Phase 11's tools, each once; ``reference`` is the validation tool's
    CPU reference, started by ``validation.start_reference``."""
    # roofline at phase 3b's shapes: every kernel, timed, against its bound
    rows, n, _ = counted("tools.roofline (--columns 256 --nz 202)", roofline.main,
                         ["--columns", "256", "--nz", str(ROOFLINE_NZ), "--iters", "3"])
    for r in rows:
        print(f"    {r['kernel']:<40} {r['time_ms']:9.4f} ms, {r['achieved_GBs']:8.1f} GB/s, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{100 * r['share_of_bound']:.1f} % of it")
        if not (np.isfinite(r["time_ms"]) and 0.0 < r["share_of_bound"] <= 1.0):
            raise AssertionError(f"roofline: {r['kernel']} ran in {r['time_ms']} ms against a "
                                 f"bound of {r['bound_ms']} ms")
    if min(n.values()) < 1:
        raise AssertionError(f"the roofline tool did not launch every kernel: {n}")

    # validation: the kernel parity (its launches counted with the rest),
    # then the device RCE against the CPU's host RCE
    val, _, _ = counted("tools.validation (--nz 8: the kernel parity, the device RCE against "
                        "its CPU reference)", validation.main, ["--nz", "8"],
                        started=[reference])
    parity = val["kernel_parity"]
    print("  tools.validation kernel parity (largest difference over the largest value; the "
          "twin's own PCR-vs-Thomas spread; limit):")
    for k, lim in val["kernel_parity_limits"].items():
        floor = parity.get(k[:-len("maxrel")] + "floor")
        print(f"    {k[:-len('_maxrel')]:<20} {parity[k]:.3e}  "
              f"{'-' if floor is None else f'{floor:.3e}'}  {lim:.1e}")
    if not (val["kernel_parity_ok"] and validation.parity_within(parity)[0]):
        raise AssertionError("validation: a kernel disagrees with its twin")
    rec, vs = val["device_rce"], val["device_rce"]["vs_cpu_f64"]
    print(f"    device RCE: status {rec['status']}, {rec['solve_iters']} solve iterations, "
          f"{rec['wall_s_total']:.2f} s; against the CPU's host RCE (converged "
          f"{val['cpu_f64']['converged']}, {val['cpu_f64']['wall_s']:.1f} s): T_surf "
          f"{vs['dT_surf_K']:+.3e} K, max |dT| {vs['dT_max_K']:.3e} K, masks equal "
          f"{vs['mask_equal']}")
    if not (rec["within_limits"] and validation.rce_within(rec, val["cpu_f64"]["converged"])):
        raise AssertionError(f"validation: the device RCE failed or left the CPU reference's "
                             f"limits {validation.RCE_LIMITS}")

    bench, _, _ = counted("tools.rce_bench (--sizes 4 --nz 8)", rce_bench.main,
                          ["--sizes", "4", "--nz", "8"])
    run = bench["runs"][0]
    print(f"    B=4: status {run['status']}, second run {run['second']['wall_s']:.2f} s "
          f"({run['second']['capture_s']:.2f} s capturing {run['second']['captures']} graphs): "
          f"{run['columns_per_s_with_capture']:.4f} columns/s, "
          f"{run['columns_per_s_without_capture']:.4f} without capture; "
          f"solve iterations {run['solve_iters']}")
    if not (run["status"] == [0] * 4 and run["finite"]):
        raise AssertionError(f"rce_bench: a lane did not converge: {run['status']}")

    recs, _, _ = counted("tools.scaling (--devices 1 --workloads toa --iters 3)", scaling.main,
                         ["--devices", "1", "--workloads", "toa", "--iters", "3"])
    rec = recs[0]
    for k, v in rec["launches"].items():  # made in the rank's own process
        launches[k] += v
    print(f"    one rank: median {rec['wall_s_median']:.3f} s a call, "
          f"{rec['columns_per_s']:.3f} columns/s, exit codes {rec['rank_exitcodes']}, "
          f"kernel launches {rec['launches']}")
    if rec["rank_exitcodes"] != [0] or min(rec["launches"].values()) < 1:
        raise AssertionError(f"scaling: the rank failed or launched no kernel: {rec}")


def main():
    t0 = time.perf_counter()
    device, smi = phase_environment()
    phase_build()
    phase_kernels(device)
    launches = phase_dispatchers(device)
    paths = [phase_radtran_path(device), phase_adiabat_path(device, smi)]
    rce_launches, rce_state = phase_rce_path(device, smi)
    paths += [rce_launches, phase_solver_path(device, smi),
              phase_device_rce_path(device, smi, rce_state), phase_climate_path(device, smi)]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    children = {}
    try:
        # phase 11's longest example, on the card beside phases 10 and 11
        children.update(start_examples(EARLY_EXAMPLES, workdir))
        paths += [phase_sharded_path(smi),
                  phase_examples_and_tools(device, smi, workdir, children)]
    finally:
        for proc, _ in children.values():
            if proc.is_alive():
                proc.kill()
            proc.join()
        shutil.rmtree(workdir, ignore_errors=True)
    for path in paths:
        for name, n in path.items():
            launches[name] = launches.get(name, 0) + n
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [dict(name=name, route="cuda", kernel=k["kernel"], source=k["source"],
                    replaces=k["replaces"], launches=launches[name],
                    **{key: RESULTS[name][key] for key in keys})
               for name, k in KERNELS.items()]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
