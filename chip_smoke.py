"""Smoke run of the PyTorch + CUDA port (clima_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. environment: torch / CUDA versions and the card's name and power limit;
   fails without a CUDA device (there is no CPU path);
2. build: the CUDA kernels from clima_tpu_torch/csrc/, with build seconds;
3. each kernel against its plain PyTorch twin on the card, float64, at the
   flagship shapes (IR two-stream with hard and soft surface and a thin
   layer; solar two-stream with 4 zenith angles, with and without amean;
   RORR with 3 species at nbin 8 and 16), at smaller shapes the solar
   kernel's 5-8 zenith build (6 angles) and RORR at a run-time nbin (12),
   plus the float32 near-tie RORR chain; kernel and twin times;
4. the main path: the synthetic nz=100, 4-zenith template built in memory,
   ``Radtran`` constructed on the card and run on one column, then the
   B=256 columns x K=8 bench-shaped batch (nz_r = 202 layers, 51 bins,
   8 gauss points, 3 k-species) through compute_opacity -> radiate_ir /
   radiate_solar -> integrate_fluxes, checked against the same calls with
   the three kernels swapped for their plain twins (ISR/OLR rtol 1e-9),
   with kernel launch counts, peak memory, and the median time of both.

The second-to-last line is a JSON object with each kernel's numbers; the
last line is the device JSON.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from clima_tpu_torch.config import species_from_dict  # noqa: E402
from clima_tpu_torch.data import make_template  # noqa: E402
from clima_tpu_torch.ops import cuda_build, rorr_cuda, twostream, twostream_cuda  # noqa: E402
from clima_tpu_torch.ops.rorr import k_rorr_mix  # noqa: E402
from clima_tpu_torch.physics import eqns  # noqa: E402
from clima_tpu_torch.radtran import Radtran, opacity, radiate  # noqa: E402

RTOL, ATOL = 1e-9, 1e-12
B_COLS, K_INNER, NZ_TEMPLATE, N_ZEN = 256, 8, 100, 4
NZ_R = 2 * NZ_TEMPLATE + 2  # flagship radiative grid (doubled + ghosts)

KERNELS = {
    "two_stream_ir_weighted": dict(
        wrapper=twostream_cuda.two_stream_ir_weighted_cuda,
        source="clima_tpu_torch/csrc/twostream.cu",
        replaces="clima_tpu/ops/pallas_twostream.py:261"),
    "two_stream_solar_multi_weighted": dict(
        wrapper=twostream_cuda.two_stream_solar_multi_weighted_cuda,
        source="clima_tpu_torch/csrc/twostream.cu",
        replaces="clima_tpu/ops/pallas_twostream.py:194"),
    "k_rorr_mix": dict(
        wrapper=rorr_cuda.k_rorr_mix_cuda,
        source="clima_tpu_torch/csrc/rorr.cu",
        replaces="clima_tpu/ops/pallas_rorr.py:145"),
}
RESULTS = {name: {"max_abs_err": 0.0} for name in KERNELS}


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
    return dev


def phase_build():
    print("== phase 2: build")
    for name in ("twostream", "rorr"):
        cuda_build.load_library(name)
        info = cuda_build.BUILD_INFO[name]
        print(f"  {name}: built in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())


def _atm(gen, rows, nz, device):
    """Random optical properties in the ranges of the JAX package's kernel tests."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((rows, nz), generator=gen, dtype=torch.float64,
                                                   device=device)
    return u(1e-6, 2.0), u(0.02, 0.999), u(0.0, 0.85)


def phase_kernels(device, B=B_COLS, nz=NZ_R, nw_ir=28, nw_sol=32, nw=51, nG=8,
                  nbin_list=(8, 16), reps=5):
    print("== phase 3: kernels against their twins, float64")
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
    r["ms"] = median_ms(lambda: twostream_cuda.two_stream_ir_weighted_cuda(*ir_args(True)), device, reps)
    r["plain_ms"] = median_ms(lambda: twostream.two_stream_ir_weighted(*ir_args(True)), device, reps)
    print(f"  IR rows={rows} nz={nz}: kernel {r['ms']:.3f} ms, twin {r['plain_ms']:.3f} ms")
    del tau, w0, gt, emis, bpl

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
    r["ms"] = median_ms(lambda: twostream_cuda.two_stream_solar_multi_weighted_cuda(
        *sol_args, with_amean=False), device, reps)
    r["plain_ms"] = median_ms(lambda: twostream.two_stream_solar_multi_weighted(
        *sol_args, with_amean=False), device, reps)
    print(f"  solar rows={rows} nz={nz} nzen={N_ZEN}: kernel {r['ms']:.3f} ms, "
          f"twin {r['plain_ms']:.3f} ms")
    del tau, w0, gt, rs, sol_args

    # the 5-8 zenith instantiation (6 angles), with and without amean
    rows = 16 * nw_sol * nG
    tau, w0, gt = _atm(gen, rows, nz, device)
    ang, zw = eqns.zenith_angles_and_weights(6)
    sol_args = (tau, w0, gt, torch.tensor(np.cos(ang * np.pi / 180.0), device=device),
                0.6 * rand(rows), torch.tensor(zw, device=device), wbin)
    for am in (True, False):
        compare("two_stream_solar_multi_weighted",
                twostream_cuda.two_stream_solar_multi_weighted_cuda(*sol_args, with_amean=am),
                twostream.two_stream_solar_multi_weighted(*sol_args, with_amean=am))
        sync(device)
    del tau, w0, gt, sol_args

    # RORR: nk=3, R = B*nw*nz lanes (all 51 master bins)
    R = B * nw * nz
    for nbin in nbin_list:
        w = 0.5 + rand(nbin)
        wb = w / w.sum()
        wb_e = torch.cat([torch.zeros(1, dtype=torch.float64, device=device), torch.cumsum(wb, 0)])
        tks = 10.0 ** (-6.0 + 7.0 * rand(3, nbin, R))
        got = rorr_cuda.k_rorr_mix_cuda(tks, wb, wb_e)
        chunk = (1 << 22) // (nbin * nbin)  # bounds the sort twin's memory
        want = torch.cat([k_rorr_mix(tks[:, :, i:i + chunk].movedim(1, -1), wb_e).movedim(-1, 0)
                          for i in range(0, R, chunk)], dim=1)
        compare("k_rorr_mix", [got], [want], atol=0.0)
        sync(device)
        if nbin == 8:
            r = RESULTS["k_rorr_mix"]
            r["ms"] = median_ms(lambda: rorr_cuda.k_rorr_mix_cuda(tks, wb, wb_e), device, reps)
            r["plain_ms"] = median_ms(
                lambda: k_rorr_mix(tks.movedim(1, -1), wb_e).movedim(-1, 0), device, reps)
            print(f"  RORR nbin=8 R={R}: kernel {r['ms']:.3f} ms, twin {r['plain_ms']:.3f} ms")
        else:
            t16 = median_ms(lambda: rorr_cuda.k_rorr_mix_cuda(tks, wb, wb_e), device, reps=2,
                            warmup=1)
            print(f"  RORR nbin={nbin} R={R}: kernel {t16:.3f} ms")
        del tks, got, want

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
    """Swap the main path's three kernel wrappers for their plain twins."""
    with mock.patch.object(opacity, "k_rorr_mix_cuda", _rorr_twin), \
            mock.patch.object(radiate, "two_stream_ir_weighted_cuda",
                              twostream.two_stream_ir_weighted), \
            mock.patch.object(radiate, "two_stream_solar_multi_weighted_cuda",
                              twostream.two_stream_solar_multi_weighted):
        yield


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


def phase_main_path(device, B=B_COLS, K=K_INNER, nz_template=NZ_TEMPLATE, reps=10):
    print("== phase 4: main path")
    nz = 2 * nz_template + 2
    tpl = make_template(nz=nz_template, n_zenith=N_ZEN)
    sp = species_from_dict(tpl["species"])
    column, batch = bench_inputs(sp, B, nz, device)
    wrappers = [k["wrapper"] for k in KERNELS.values()]
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(device)

    # the facade on one column, then the bench-shaped batch, through the kernels
    rad = Radtran(sp.gas_names, [], tpl["settings"], tpl["star"], N_ZEN, 0.25, nz,
                  tpl["datadir"], device=device)
    isr1, olr1 = rad.TOA_fluxes(290.0, *column)
    fup_sol = rad.wrk_sol.fup_n
    radiate_many = make_radiate_many(rad, K)
    isr, olr = radiate_many(*batch)
    sync(device)
    launches = {name: k["wrapper"].launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    print(f"  Radtran one column: ISR {isr1:.6f} OLR {olr1:.6f} mW/m^2; "
          f"wrk_sol.fup_n shape {fup_sol.shape}")
    print(f"  batch B={B} K={K} nz_r={nz}: ISR mean {float(isr.mean()) / K:.6f} "
          f"OLR mean {float(olr.mean()) / K:.6f} mW/m^2")
    print(f"  kernel launches on the main path: {launches}")
    print(f"  peak device memory: {peak / 2**30:.3f} GiB")
    if not (np.isfinite([isr1, olr1]).all() and bool(torch.isfinite(isr).all())
            and bool(torch.isfinite(olr).all())):
        raise AssertionError("non-finite TOA fluxes")
    if isr.shape != (B,) or olr.shape != (B,) or fup_sol.shape != (nz + 1,):
        raise AssertionError("unexpected output shapes")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

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
    if any(k["wrapper"].launches != launches[name] for name, k in KERNELS.items()):
        raise AssertionError("the twin path launched a kernel")
    compare("batch ISR/OLR (kernel vs twin path)", [isr, olr], [isr_p, olr_p], atol=0.0)

    t_kernel = median_ms(lambda: radiate_many(*batch), device, reps, warmup=1)
    t_plain = median_ms(lambda: radiate_many_plain(*batch), device, reps, warmup=1)
    solves = (rad.ir.nw * rad.op.kset.nbin + rad.sol.nw * rad.op.kset.nbin * N_ZEN) * B * K
    print(f"  batch time (median of {reps}): kernel path {t_kernel:.3f} ms, "
          f"plain path {t_plain:.3f} ms")
    print(f"  two-stream solves/s: kernel path {solves / (t_kernel / 1e3):.6e}, "
          f"plain path {solves / (t_plain / 1e3):.6e} ({solves} solves per batch)")
    return launches


def main():
    t0 = time.perf_counter()
    device = phase_environment()
    phase_build()
    phase_kernels(device)
    launches = phase_main_path(device)
    kernels = [dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
                    launches=launches[name], max_abs_err=RESULTS[name]["max_abs_err"],
                    ms=RESULTS[name]["ms"], plain_ms=RESULTS[name]["plain_ms"])
               for name, k in KERNELS.items()]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
