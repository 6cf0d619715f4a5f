"""Sub-stage timing inside ``compute_opacity`` on an NVIDIA H100 (the port
of the JAX package's ``scripts/opacity_substages.py`` and
``scripts/opacity_profile.py``).

The workload of ``tools/profile_stages.py`` (:func:`.profile_stages.
bench_workload`: 256 jittered columns of the nz 100 template, 202 radiative
layers). One pass of ``compute_opacity``'s own stages (the private functions
of ``radtran/opacity.py`` that it chains) records every stage's real inputs;
each stage is then timed on them (:func:`.profile_stages.measure`: host ms,
event ms, and launches and device-busy ms from one profiler pass):

- ``hat_weights``: each k-table's bilinear hat weights (``_kweights``);
- ``ktable_f64``: the k-table contractions times the species columns
  (``_k_distributions``), and ``ktable_f32`` the same in float32 with TF32
  off (not part of the chain; its largest difference from float64 is given);
- ``rorr_kernel``: the RORR mix of the (nk, nbin, nw B nz) species tensor
  through the kernel (``_mix``), and ``rorr_sort`` through the sort path
  (``ops.rorr.k_rorr_mix``, chunked as ``_rorr_mix`` chunks it past nbin 16;
  not part of the chain; its largest difference from the kernel is given);
- ``rayleigh``, ``absorption`` (CIA, photolysis and the other
  cross-sections, the water continuum), ``particles`` (with
  ``--particles`` only: the bench template has none, so this adds its HCaer
  haze), ``combine`` (the scattering clamp and asymmetry, then the combine);
- ``whole``: ``compute_opacity`` itself, and ``rest`` = whole - the sum of
  the chain's stages above (the flips, the columns, the custom-property
  fill and the allocations between them).

The stages composed once give ``compute_opacity``'s outputs bitwise, which
the tool checks and prints: both run the same functions. Each stage with a
count in ``tools/roofline.py`` carries its bound (``kinterp_work``,
``rorr_work``, ``opacity_work``). The JAX script also timed its k-table
matmuls at TF32-like and bf16 precisions; ``ops.interp.pdot`` refuses TF32
by design (the port keeps TF32 off in every precision-sensitive
contraction), so those have no counterpart here.

    python -m clima_tpu_torch.tools.opacity_substages [--columns 256] [--nz 202]
        [--iters 10] [--particles] [--device cpu] [--out FILE]

On the CPU (``--device cpu``) the wrappers run their plain twins, the host
clock times them, and the device fields are null.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import roofline
from .profile_stages import bench_workload, card_name_and_limit, measure

__all__ = ["CHAIN", "run_stages", "main"]

# the stages whose sum, with rest, makes the whole
CHAIN = ("hat_weights", "ktable_f64", "rorr_kernel", "rayleigh", "absorption", "particles",
         "combine")


def run_stages(op, P, T, dens, dz, pdens=None, radii=None):
    """``compute_opacity``'s stages, run one after the other as it runs
    them; returns (its outputs, {stage: (function, its arguments)})."""
    from ..radtran import opacity as om

    args = {}

    def stage(name, fn, *a):
        args[name] = (fn, a)
        return fn(*a)

    P, T, dens, dz, pdens, radii, log10P, cols = om._toa_down(P, T, dens, dz, pdens, radii)
    weights = stage("hat_weights", om._kweights, op, log10P, T)
    tau_ks = stage("ktable_f64", om._k_distributions, op, weights, cols)
    tau_kmix = stage("rorr_kernel", om._mix, op, tau_ks)
    zeros = torch.zeros(T.shape + (op.nw,), dtype=T.dtype, device=T.device)
    tausg = stage("rayleigh", om._rayleigh, op, cols, zeros)
    taua = stage("absorption", om._absorption, op, T, dens, dz, cols, zeros)
    tauc, tausc, g0c = om._custom_properties(None, P, dz, zeros)
    taup, tausp, gt_num = stage("particles", om._particles, op, pdens, radii, dz, zeros)
    out = stage("combine", om._combine, op, tau_kmix, tausg, taua, tauc, tausc, g0c, taup,
                tausp, gt_num)
    return out, args


def _maxrel(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1e-300)).max())


def main(argv=None):
    """Time each sub-stage; returns dict(device, card, columns, nz,
    composed_bitwise, stages: [one record per stage]), each record also
    printed as a JSON line."""
    ap = argparse.ArgumentParser(prog="python -m clima_tpu_torch.tools.opacity_substages",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--columns", type=int, default=256)
    ap.add_argument("--nz", type=int, default=202, help="radiative layers (template 2 nz + 2)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--particles", action="store_true", help="add the HCaer haze and its stage")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--out", default=None, help="write the whole JSON to this file")
    args = ap.parse_args(argv)

    from ..radtran import compute_opacity
    from ..radtran import opacity as om
    from ..radtran.data import optical_data_to
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    card = card_name_and_limit(device)
    rad, x = bench_workload(args.columns, args.nz, device, particles=args.particles)
    op = rad.op
    inputs = (x["P"], x["T"], x["dens"], x["dz"], x.get("pdens"), x.get("radii"))
    whole = compute_opacity(op, *inputs)
    composed, stages = run_stages(op, *inputs)
    bitwise = all(torch.equal(composed[k], whole[k]) for k in whole)
    print(json.dumps(dict(composed_bitwise=bitwise)), flush=True)
    if not bitwise:
        raise AssertionError("the composed stages differ from compute_opacity")
    if not all(bool(torch.isfinite(v).all()) for v in whole.values()):
        raise AssertionError("compute_opacity gave non-finite values")
    if not args.particles:
        del stages["particles"]

    B, nz, nw, nbin, nk = args.columns, args.nz, op.nw, op.kset.nbin, len(op.k)
    ng = x["dens"].shape[-1]
    shapes = [kt.log10k.shape for kt in op.k]  # (G, P, T, W)
    kinterp = [roofline.kinterp_work(B, nz, G, W, nP, nT) for G, nP, nT, W in shapes]
    work = {"ktable_f64": (sum(w[0] for w in kinterp), sum(w[1] for w in kinterp)),
            "rorr_kernel": roofline.rorr_work(B * nw * nz, nbin, nk),
            "rorr_sort": roofline.rorr_work(B * nw * nz, nbin, nk),
            "whole": roofline.opacity_work(B, nz, nw, nbin, ng, nk)}

    # the variants off the chain: float32 k-tables (TF32 off), the sort path
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    op32 = optical_data_to(op, device, torch.float32)
    fn, (_, weights, cols) = stages["ktable_f64"]
    weights32, cols32 = [w.float() for w in weights], cols.float()
    mix, (_, tau_ks) = stages["rorr_kernel"]
    variants = {"ktable_f32": (fn, (op32, weights32, cols32)),
                "rorr_sort": (om._rorr_sort, (tau_ks.reshape(nk, nbin, -1), op.kset.wbin_e))}
    diffs = {"ktable_f32": _maxrel(fn(op32, weights32, cols32).double(), tau_ks),
             "rorr_sort": _maxrel(om._rorr_sort(*variants["rorr_sort"][1]).reshape(
                 nbin, nw, B, nz), mix(op, tau_ks))}
    order = ["hat_weights", "ktable_f64", "ktable_f32", "rorr_kernel", "rorr_sort", "rayleigh",
             "absorption", "particles", "combine"]
    stages.update(variants)

    records = []
    try:
        for name in [n for n in order if n in stages]:
            fn, a = stages[name]
            rec = dict(stage=name, in_chain=name in CHAIN,
                       **measure(lambda: fn(*a), device, args.iters))
            if name in diffs:
                rec["max_rel_diff"] = diffs[name]
            records.append(rec)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    records.append(dict(stage="whole", in_chain=False,
                        **measure(lambda: compute_opacity(op, *inputs), device, args.iters)))
    ms = lambda r: r["event_ms"] if r["event_ms"] is not None else r["host_ms"]
    chain = [r for r in records if r["in_chain"]]
    rest = dict(stage="rest", in_chain=True,
                host_ms=records[-1]["host_ms"] - sum(r["host_ms"] for r in chain))
    if device.type == "cuda":
        for key in ("event_ms", "busy_ms", "launches"):
            parts = [records[-1][key]] + [r[key] for r in chain]
            rest[key] = None if None in parts else parts[0] - sum(parts[1:])
    records.append(rest)
    for rec in records:
        if rec["stage"] in work and rec.get("host_ms") is not None:
            bound_ms, by = roofline.bound(*work[rec["stage"]])
            rec.update(bound_ms=bound_ms, bound_by=by, share_of_bound=bound_ms / ms(rec))
        print(json.dumps(rec), flush=True)
    out = dict(device=str(device), card=card, columns=B, nz=nz, nw=nw, nbin=nbin, nk=nk,
               particles=args.particles, iters=args.iters, composed_bitwise=bitwise,
               stages=records)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
