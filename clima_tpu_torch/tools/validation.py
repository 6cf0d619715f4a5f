"""Validation of the port on the CUDA card against the CPU (the port of the
JAX package's ``scripts/tpu_validation.py``).

1. Kernel parity: the unreduced two-stream kernels (#6 single-zenith solar,
   #5 multi-zenith solar at 4 zenith cosines, #4 IR) through
   ``two_stream_*_auto``, and RORR, against their plain twins on the same
   seeded inputs (the JAX script's shapes and ranges), float64; the largest
   difference of each output (the solar ones' surface radiance too, on the
   columns thinned 1000-fold, where the direct beam reaches the surface)
   over its largest value, held to a fixed limit (:data:`PARITY_LIMITS`), beside the
   same measure between the twin's own two tridiagonal solves (PCR and
   Thomas), which says how far float64 roundoff alone moves these outputs.
   The twins are called directly: ``set_pallas_mode("never")`` refuses card
   tensors.
2. Device RCE on the card: ``rce_device.batched_rce`` in float64 at
   ``--nz`` layers (one zenith angle) over two lanes, the 400 ppm column and
   one with 4x the CO2 and perturbed guesses, both from the card's
   ``surface_temperature`` warm start; records each lane's status, the
   max|F/F0| trajectory of lane 0, the iteration counts and the wall time.
3. CPU reference: the port's own host ``RCE`` of the 400 ppm column in
   float64 on the CPU, run in a child process (started first, so that it
   runs while the card works) from the CPU's own warm start, and the card's
   lane 0 against it: T_surf and T deltas and whether the convection masks
   agree, held to :data:`RCE_LIMITS`.

``--particles`` adds the same comparison with the 10 cm^-3 haze of
:func:`set_haze`. The JAX script's float32-pair (df64) and plain float32
modes are not ported: the card has float64, and float32 is no parity mode
(the solar source's lam^2 = 1/u0^2 resonance).

    python -m clima_tpu_torch.tools.validation [--nz 12] [--particles] [--out FILE]

It needs a CUDA card: it compares the card with the CPU. A caller that wants
the CPU reference to run beside other work starts it first
(:func:`start_reference`) and passes it to :func:`main`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["main", "model", "set_haze", "column_P_i", "kernel_parity", "parity_within",
           "rce_within", "cpu_reference", "start_reference", "PARITY_LIMITS", "RCE_LIMITS"]

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the largest difference over the largest value that each output may show
# against its twin in kernel_parity: 1e-9, and 2e-9 for #4's IR fluxes, on
# whose inputs the twin's own two tridiagonal solves part by 9.0e-10 and
# 9.5e-10 (the kernel against the twin: 1.25e-9 and 1.27e-9 on an H100)
PARITY_LIMITS = dict(ir_fup=2.0e-9, ir_fdn=2.0e-9)
PARITY_RTOL = 1.0e-9

# the card's batched_rce (lane 0) against the CPU's host RCE of the same
# column, both stopped at max|F/F0| < 1e-5: their solutions part by what
# that tolerance leaves (on an H100 at nz 8, 12 and 12 with the haze:
# T_surf 3.6e-4, 2.6e-5 and 7.6e-4 K; T 1.1e-2, 6.5e-3 and 5.1e-3 K), and
# the limits are about ten times the largest of these
RCE_LIMITS = dict(dT_surf_K=5.0e-3, dT_max_K=0.1)


def model(nz, device, particles=False, xtol_rc=None):
    """The validation column's model: the template at ``nz`` layers, one
    zenith angle, with the haze of :func:`set_haze` where ``particles``."""
    from ..adiabat import AdiabatClimate
    from ..data import make_template

    t = make_template(nz=nz, n_zenith=1, particles=particles)
    c = AdiabatClimate(t["species"], t["settings"], t["star"], t["datadir"], device=device)
    c.verbose = False
    if xtol_rc is not None:
        c.xtol_rc = xtol_rc
    if particles:
        set_haze(c)
    return c


def set_haze(c):
    """A prescribed optically active haze (test_adiabat.f90:216-230: the
    particle setter feeding RCE), 10 cm^-3 of 0.1 um particles from 2 bar to
    1 dyn/cm^2: it shifts the equilibrium T_surf by ~4 K and stays well
    conditioned (denser synthetic khare1984 haze outruns ISR)."""
    n = len(c.particle_names)
    c.set_particle_density_and_radii(np.geomspace(2.0e6, 1.0, 8), np.full((8, n), 1.0e1),
                                     np.full((8, n), 1.0e-5))


def column_P_i(c):
    """H2O 270 bar, CO2 400 dyn/cm^2, N2 1 bar."""
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0
    P_i[c.species_names.index("N2")] = 1.0e6
    return P_i


def cpu_reference(nz, particles=False, xtol_rc=None):
    """The host RCE of the validation column on the CPU, from its own
    ``surface_temperature`` warm start."""
    c = model(nz, "cpu", particles, xtol_rc)
    P_i = column_P_i(c)
    T_guess = c.surface_temperature(P_i, T_guess=280.0)
    t0 = time.perf_counter()
    converged = c.RCE(P_i, T_guess, c.T.copy())
    return dict(nz=nz, particles=particles, xtol_rc=c.xtol_rc, T_surf=float(c.T_surf),
                T=c.T.tolist(),
                mask=[bool(b) for b in c.convecting_with_below], converged=bool(converged),
                wall_s=time.perf_counter() - t0, T_surf_guess=float(T_guess))


class Reference(NamedTuple):
    """A CPU reference started by :func:`start_reference`."""
    nz: int
    particles: bool
    xtol_rc: float
    path: str  # the JSON file it writes, in a temporary directory of its own
    proc: subprocess.Popen


def start_reference(nz, particles=False, xtol_rc=1.0e-5):
    """Start :func:`cpu_reference` in a child process of the port, on the
    CPU; :func:`main` waits for it, reads it and removes its directory."""
    path = os.path.join(tempfile.mkdtemp(prefix="clima_tpu_torch_validation_"), "cpuref.json")
    cmd = [sys.executable, "-m", "clima_tpu_torch.tools.validation", "--cpu-ref", path,
           "--nz", str(nz), "--xtol-rc", str(xtol_rc)] + (["--particles"] if particles else [])
    proc = subprocess.Popen(cmd, cwd=PACKAGE_ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return Reference(nz, particles, xtol_rc, path, proc)


def _maxrel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def kernel_parity(device, seed=1):
    """Each unreduced kernel and RORR against its twin on the JAX script's
    inputs (512 rows x 202 layers; RORR 3 species x 64 bins x 202 layers at
    nbin 8), float64. Returns {output: largest difference over its largest
    value} (``surfrad``: the solar kernels' surface radiance, on the same
    columns thinned 1000-fold), and beside
    each two-stream output ``<output>_floor``: the same
    measure between the twin's two tridiagonal solves (block PCR and
    Thomas), the spread that float64 roundoff alone gives these inputs (the
    random Planck values per edge over log-uniform optical depths make the
    IR's linear-in-tau source cancel, ~1e-9 of the largest flux)."""
    from ..ops import rorr_cuda, twostream, twostream_cuda
    from ..ops.rorr import k_rorr_mix

    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(x, dtype=torch.float64, device=device)
    B, nzl = 512, 202
    tau = t(10.0 ** rng.uniform(-6, 1.5, (B, nzl)))
    w0, gt = t(rng.uniform(0.05, 0.999, (B, nzl))), t(rng.uniform(0.0, 0.9, (B, nzl)))
    u0, alb = t(rng.uniform(0.2, 1.0, B)), t(rng.uniform(0.0, 0.6, B))
    emis, bpl = t(rng.uniform(0.8, 1.0, B)), t(rng.uniform(1e-2, 1.0, (B, nzl + 1)))
    u0s = t(rng.uniform(0.2, 1.0, 4))  # zenith cosines shared by all rows
    # these columns' total optical depths (~10^2 to 10^3) put the direct beam
    # at the surface below 1e-30: the surface radiance is compared on the
    # same columns thinned 1000-fold (total optical depths ~0.1 to 1)
    thin = tau * 1.0e-3

    def solar(fn, mu):
        amean, _, fup, fdn = fn(tau, w0, gt, mu, alb)
        return amean, fn(thin, w0, gt, mu, alb)[1], fup, fdn

    kernels = dict(
        solar=(solar(twostream_cuda.two_stream_solar_auto, u0), ("amean", "surfrad", "fup", "fdn"),
               lambda: solar(twostream.two_stream_solar, u0)),
        solar_multi=(solar(twostream_cuda.two_stream_solar_multi_auto, u0s),
                     ("amean", "surfrad", "fup", "fdn"),
                     lambda: solar(twostream.two_stream_solar_multi, u0s)),
        ir=(twostream_cuda.two_stream_ir_auto(tau, w0, gt, emis, True, 1e-6, bpl), ("fup", "fdn"),
            lambda: twostream.two_stream_ir(tau, w0, gt, emis, True, 1e-6, bpl)))
    out = {}
    for label, (got, names, twin) in kernels.items():
        want = twin()
        twostream.set_tridiag_method("thomas")
        try:
            other = twin()
        finally:
            twostream.set_tridiag_method("pcr")
        for name, g, w, o in zip(names, got, want, other):
            out[f"{label}_{name}_maxrel"] = _maxrel(g, w)
            out[f"{label}_{name}_floor"] = _maxrel(o, w)

    nk, nw, nzc, nbin = 3, 64, 202, 8
    wbin = np.polynomial.legendre.leggauss(nbin)[1] / 2.0
    wbin_e = np.concatenate([[0.0], np.cumsum(wbin)])
    wbin_e[-1] = 1.0
    tau_ks = t(10.0 ** rng.uniform(-6, 2, (nk, nw * nzc, nbin)))  # (nk, lanes, nbin)
    mixed = rorr_cuda.k_rorr_mix_cuda(tau_ks.permute(0, 2, 1).contiguous(), t(wbin), t(wbin_e))
    out["rorr_maxrel"] = _maxrel(mixed.T, k_rorr_mix(tau_ks, t(wbin_e)))
    return out


def parity_within(parity):
    """Whether every output of :func:`kernel_parity` is within its limit
    (:data:`PARITY_LIMITS`, else :data:`PARITY_RTOL`). Returns (ok,
    {output: its limit})."""
    limits = {k: PARITY_LIMITS.get(k[:-len("_maxrel")], PARITY_RTOL)
              for k in parity if k.endswith("_maxrel")}
    return all(parity[k] <= v for k, v in limits.items()), limits


def rce_within(rec, ref_converged):
    """Whether the card's device RCE (a ``device_rce`` record of
    :func:`main`) converged in both lanes, as the CPU's host RCE did, with
    the same convection mask and within :data:`RCE_LIMITS` of it."""
    vs = rec["vs_cpu_f64"]
    return (rec["status"] == [0, 0] and all(rec["converged"]) and ref_converged
            and vs["mask_equal"] and abs(vs["dT_surf_K"]) < RCE_LIMITS["dT_surf_K"]
            and vs["dT_max_K"] < RCE_LIMITS["dT_max_K"])


def _device_rce(c, particles):
    """Two lanes of batched_rce on the card from its own warm start."""
    from ..adiabat.rce_device import batched_rce

    P_i = column_P_i(c)
    t0 = time.perf_counter()
    T_guess = c.surface_temperature(P_i, T_guess=280.0)
    warm_s = time.perf_counter() - t0
    P_b = np.tile(P_i, (2, 1))
    P_b[1, c.species_names.index("CO2")] *= 4.0
    T_s = np.array([T_guess, T_guess + 5.0])
    T_seed = np.tile(c.T, (2, 1))
    T_seed[1] += 2.0
    torch.cuda.synchronize(c.device)
    t0 = time.perf_counter()
    out = batched_rce(c, P_b, T_s, T_seed, record_trace=True)
    out = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in out.items()}
    wall = time.perf_counter() - t0
    trace = out["ratio_trace"][0]
    return dict(
        nz=c.nz, dtype="float64", xtol_rc=c.xtol_rc, particles=particles,
        columns=2, warm_start_s=warm_s, wall_s_total=wall,
        converged=out["converged"].astype(bool).tolist(), status=out["status"].astype(int).tolist(),
        ratio_best=out["ratio_best"].tolist(), ratio_floor=out["ratio_floor"].tolist(),
        max_ratio=out["max_ratio"].tolist(), rc_iters=out["rc_iters"].astype(int).tolist(),
        solve_iters=out["solve_iters"].astype(int).tolist(),
        ratio_trace=trace[np.isfinite(trace)].tolist(), T_surf=out["T_surf"].tolist(),
        T=out["T"].tolist(), mask=out["convecting_with_below"].astype(int).tolist())


def _against(rec, ref):
    """Lane 0 of the card's solve against the CPU's host RCE."""
    T0, mask0 = np.asarray(rec["T"][0]), np.asarray(rec["mask"][0], bool)
    return dict(mask_ref=[int(b) for b in ref["mask"]], T_ref=ref["T"], vs_cpu_f64=dict(
        dT_surf_K=rec["T_surf"][0] - ref["T_surf"],
        dT_max_K=float(np.abs(T0 - np.asarray(ref["T"])).max()),
        mask_equal=bool((mask0 == np.asarray(ref["mask"])).all())))


def main(argv=None, started=()):
    """Run the three parts; returns the result dict (also written to
    ``--out``). ``started``: CPU references already started by
    :func:`start_reference` for this run's columns; the others are started
    here."""
    ap = argparse.ArgumentParser(prog="python -m clima_tpu_torch.tools.validation",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--nz", type=int, default=12)
    ap.add_argument("--xtol-rc", type=float, default=1.0e-5)
    ap.add_argument("--particles", action="store_true", help="add the haze column")
    ap.add_argument("--out", default=None, help="write the result to this JSON file")
    ap.add_argument("--cpu-ref", default=None,
                    help="(the child process) write the CPU reference to this file")
    args = ap.parse_args(argv)

    if args.cpu_ref:
        torch.set_num_threads(4)
        ref = cpu_reference(args.nz, args.particles, args.xtol_rc)
        with open(args.cpu_ref + ".part", "w") as f:
            json.dump(ref, f)
        os.replace(args.cpu_ref + ".part", args.cpu_ref)  # whole, or not there
        return None
    if not torch.cuda.is_available():
        raise RuntimeError("tools/validation.py compares the CUDA card with the CPU, and there "
                           "is no CUDA device here")
    device = torch.device("cuda", torch.cuda.current_device())
    cases = [False, True] if args.particles else [False]
    children = {r.particles: r for r in started}
    try:
        if any((r.nz, r.xtol_rc) != (args.nz, args.xtol_rc) or r.particles not in cases
               for r in started):
            raise ValueError(f"a started reference is not one of this run's columns: {started}")
        for particles in cases:
            if particles not in children:
                children[particles] = start_reference(args.nz, particles, args.xtol_rc)
        result = dict(platform="cuda", kind=torch.cuda.get_device_name(device), nz=args.nz,
                      dtype="float64")
        t0 = time.perf_counter()
        result["kernel_parity"] = kernel_parity(device)
        result["kernel_parity_s"] = time.perf_counter() - t0
        result["kernel_parity_ok"], result["kernel_parity_limits"] = parity_within(
            result["kernel_parity"])
        print("kernel parity:", json.dumps(result["kernel_parity"]), flush=True)
        for particles in cases:
            # the card's warm start and solve run while the CPU child works
            child = children[particles]
            tag = "_particles" if particles else ""
            rec = _device_rce(model(args.nz, device, particles, args.xtol_rc), particles)
            if child.proc.wait() != 0:
                raise RuntimeError(f"the CPU reference{tag} failed with exit code "
                                   f"{child.proc.returncode}")
            with open(child.path) as f:
                ref = json.load(f)
            if (ref["nz"], ref["particles"], ref["xtol_rc"]) != (args.nz, particles, args.xtol_rc):
                raise ValueError(f"{child.path} holds the reference of nz={ref['nz']}, particles="
                                 f"{ref['particles']}, xtol_rc={ref['xtol_rc']}")
            result[f"cpu_f64{tag}"] = dict(T_surf=ref["T_surf"], converged=ref["converged"],
                                           wall_s=ref["wall_s"])
            rec.update(_against(rec, ref))
            rec["within_limits"] = rce_within(rec, ref["converged"])
            result[f"device_rce{tag}"] = rec
            vs = rec["vs_cpu_f64"]
            print(f"device_rce{tag}: status {rec['status']}, dT_surf {vs['dT_surf_K']:+.3e} K, "
                  f"max |dT| {vs['dT_max_K']:.3e} K, masks equal {vs['mask_equal']}, "
                  f"{rec['wall_s_total']:.1f} s", flush=True)
    finally:
        for child in children.values():
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait()
            shutil.rmtree(os.path.dirname(child.path), ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
