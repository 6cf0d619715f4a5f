"""Builds of ``csrc/twostream.cu`` side by side on one card, in one run.

    python -m clima_tpu_torch.tools.compare_twostream_builds \\
        old=path/to/old/twostream.cu new=clima_tpu_torch/csrc/twostream.cu [...]

Each ``name=path`` source is built with the flags of ``ops/cuda_build.py``
into ``clima_tpu_torch/_build/compare/`` (all builds started together) and
ptxas's registers and spills are printed for every kernel instance. Every
build then runs, through the port's wrappers,
- the weighted IR kernel (#1) at the radtran path's shape (57344 rows x 202
  layers, nG 8) and the adiabat path's (1792 rows x 102 layers), in float64
  and float32, hard surface, random inputs in chip_smoke.py's ranges with a
  thin layer;
- the weighted solar kernel (#2) at the radtran path's shape (65536 rows x
  202 layers, nG 8, the 4 Gauss zenith cosines, amean on), float64;
- the unreduced kernels (#4-#6) at the roofline shapes (122880 rows x 202
  layers, the inputs of chip_smoke.py's phase 3b), #4 with a hard and a soft
  surface, #5 at 4 and 12 zenith angles, and beside #4 the weighted IR
  kernel at nG = 1 on #4's inputs, called as #1 with wbin = [1] (the
  unreduced fluxes but for the sign of a zero), whatever route the build's
  #4 takes.
A build whose library still has the thread-per-row template's entry point
(``clima_twostream_rows``, before the unreduced IR and single-zenith solar
solves had kernels of their own) runs #4 and #6 on that template, as the
wrappers of its day did, and #5 through its ``clima_twostream_solar_multi``,
which had no per-row flag.
Every build's outputs are compared bitwise with every other build's, and the
largest difference from the first build is printed; #1's float64 outputs and
#2's are also held to the plain twin (rtol 1e-9, atol 1e-12).
The builds are timed in turns with CUDA events (the first build, the others,
the others again in reverse order, the first again; each time the mean of
``--reps`` launches after a warm-up), and each build's two times are
printed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..ops import cuda_build, twostream, twostream_cuda
from ..physics import eqns

_OUT = os.path.join(cuda_build._PKG, "_build", "compare")
_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# the C entry points of a library with the thread-per-row template, where
# they differ from ops/cuda_build.py's
_ROW_TEMPLATE_SIGNATURES = {
    "clima_twostream_rows": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _D, _P, _P, _P,
                             _P, _P, _P],
    "clima_twostream_solar_multi": [_I, _P, _P, _P, _P, _P, _I, _LL, _I, _P, _P, _P, _P, _P, _P],
}


def build(name, path):
    """Build ``path`` as library ``name``; returns (its entry points as
    ``cuda_build.load_library`` gives them, ptxas's lines)."""
    os.makedirs(_OUT, exist_ok=True)
    out = os.path.join(_OUT, f"lib{name}.so")
    res = subprocess.run([cuda_build._nvcc(), *cuda_build._FLAGS, "-o", out, path],
                         capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{log}")
    lib = ctypes.CDLL(out)
    fns = {}
    signatures = dict(cuda_build._SIGNATURES["twostream"])
    if hasattr(lib, "clima_twostream_rows"):
        signatures.update(_ROW_TEMPLATE_SIGNATURES)
    for fname, argtypes in signatures.items():
        if hasattr(lib, fname):
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[fname] = fn
    lines, fn = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn and ("registers" in line or "spill" in line):
            lines.append(f"{fn}: {line.strip()}")
    return fns, lines


def _row_template_launchers(fns):
    """``twostream_cuda._launch_ir_rows`` and ``_launch_solar_multi`` for a
    library with the thread-per-row template (``clima_twostream_rows``): #4
    and #6 on the template, with its (nz, 4, rows) scratch, and #5 through
    the template-era ``clima_twostream_solar_multi``, which took no per-row
    flag."""
    rows_fn, multi_fn = fns["clima_twostream_rows"], fns["clima_twostream_solar_multi"]

    def ir_rows(tau, w0, gt, emissivity, bplanck, hard, tau_min):
        rows, nz = tau.shape
        kw = dict(dtype=tau.dtype, device=tau.device)
        scratch = torch.empty((nz, 4, rows), **kw)
        fup, fdn = (torch.empty((rows, nz + 1), **kw) for _ in range(2))
        _status(rows_fn(int(tau.dtype == torch.float64), 0, 0, tau.data_ptr(), w0.data_ptr(),
                        gt.data_ptr(), emissivity.data_ptr(), bplanck.data_ptr(), None, 1, rows,
                        nz, int(hard), float(tau_min), scratch.data_ptr(), None, fup.data_ptr(),
                        fdn.data_ptr(), None, _stream(tau)))
        return fup, fdn

    def solar_multi(tau, w0, gt, u0s, Rsfc, per_row=False):
        rows, nz = tau.shape
        nzen = 1 if per_row else u0s.shape[0]
        kw = dict(dtype=tau.dtype, device=tau.device)
        am, fup, fdn = (torch.empty((nzen, rows, nz + 1), **kw) for _ in range(3))
        srad = torch.empty((nzen, rows), **kw)
        if per_row:
            scratch = torch.empty((nz, 4, rows), **kw)
            status = rows_fn(int(tau.dtype == torch.float64), 1, 1, tau.data_ptr(),
                             w0.data_ptr(), gt.data_ptr(), Rsfc.data_ptr(), None,
                             u0s.data_ptr(), 1, rows, nz, 0, 0.0, scratch.data_ptr(),
                             am.data_ptr(), fup.data_ptr(), fdn.data_ptr(), srad.data_ptr(),
                             _stream(tau))
        else:
            scratch = torch.empty(nz * rows * (3 + 2 * nzen), **kw)
            status = multi_fn(int(tau.dtype == torch.float64), tau.data_ptr(), w0.data_ptr(),
                              gt.data_ptr(), Rsfc.data_ptr(), u0s.data_ptr(), nzen, rows, nz,
                              scratch.data_ptr(), am.data_ptr(), fup.data_ptr(), fdn.data_ptr(),
                              srad.data_ptr(), _stream(tau))
        _status(status)
        return am, srad, fup, fdn

    return ir_rows, solar_multi


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _status(status):
    if status != 0:
        raise RuntimeError(f"two-stream kernel launch failed: CUDA error {status}")


@contextlib.contextmanager
def using(fns):
    """The wrappers of ``ops/twostream_cuda.py`` launch the kernels of ``fns``
    (#4 and #6 on the thread-per-row template where ``fns`` has it)."""
    saved = (twostream_cuda.load_library, twostream_cuda._launch_ir_rows,
             twostream_cuda._launch_solar_multi)
    twostream_cuda.load_library = lambda _name: fns
    if "clima_twostream_rows" in fns:
        twostream_cuda._launch_ir_rows, twostream_cuda._launch_solar_multi = \
            _row_template_launchers(fns)
    try:
        yield
    finally:
        (twostream_cuda.load_library, twostream_cuda._launch_ir_rows,
         twostream_cuda._launch_solar_multi) = saved


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(label, built, fn, reps, want=None):
    """Run ``fn`` on each build, compare its outputs bitwise with the other
    builds' (and with ``want`` at rtol 1e-9 / atol 1e-12), time the builds in
    turns and print a line per build."""
    names = list(built)
    outs = {}
    for n in names:
        with using(built[n][0]):
            outs[n] = [x for x in fn() if x is not None]
    torch.cuda.synchronize()
    times = {n: [] for n in names}
    for n in [names[0], *names[1:], *names[1:][::-1], names[0]]:
        with using(built[n][0]):
            times[n].append(event_ms(fn, reps))
    first = outs[names[0]]
    for n, out in outs.items():
        same = [m for m in names if m != n
                and all(torch.equal(a, b) for a, b in zip(out, outs[m]))]
        diff = max(float((a - b).abs().max()) for a, b in zip(out, first))
        line = (f"{label} {n}: {' / '.join(f'{t:.4f}' for t in times[n])} ms; "
                f"bitwise equal to: {', '.join(same) or 'none'}; "
                f"largest difference from {names[0]}: {diff:.3e}")
        if want is not None:
            ok = all(torch.allclose(a, b, rtol=1e-9, atol=1e-12) for a, b in zip(out, want))
            err = max(float((a - b).abs().max()) for a, b in zip(out, want))
            line += f"; against the twin: max abs err {err:.3e}, within rtol 1e-9: {ok}"
        print(line, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="name=path")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    specs = dict(s.split("=", 1) for s in args.sources)
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as ex:
        built = dict(zip(specs, ex.map(lambda n: build(n, specs[n]), specs)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for name, (_, lines) in built.items():
        for line in lines:
            print(f"ptxas {name}: {line}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.rand(shape, generator=gen, dtype=torch.float64, device=dev)
    nG = 8
    wbin = torch.tensor(np.polynomial.legendre.leggauss(nG)[1] / 2.0, device=dev)

    for label, rows, nz in (("radtran shape", 57344, 202), ("adiabat shape", 1792, 102)):
        tau = 1e-6 + (2.0 - 1e-6) * rand(rows, nz)
        tau[2, 5] = 1e-7
        w0, gt = 0.02 + 0.979 * rand(rows, nz), 0.85 * rand(rows, nz)
        emis, bpl = 0.8 + 0.2 * rand(rows), 1e-2 + rand(rows, nz + 1)
        for dtype in (torch.float64, torch.float32):
            a = [x.to(dtype) for x in (tau, w0, gt, emis)] + [True, 1e-6, bpl.to(dtype),
                                                               wbin.to(dtype)]
            want = twostream.two_stream_ir_weighted(*a) if dtype == torch.float64 else None
            compare(f"#1 {label} ({rows} x {nz}) {str(dtype)[6:]}", built,
                    lambda a=a: twostream_cuda.two_stream_ir_weighted_cuda(*a), args.reps, want)
            del a, want
        del tau, w0, gt, emis, bpl
        torch.cuda.empty_cache()

    # the unreduced kernels at the roofline shapes
    rows, nz = 256 * 60 * 8, 202
    tau = 1e-6 + (2.0 - 1e-6) * rand(rows, nz)
    tau[3, 7] = 1e-7
    w0, gt = 0.02 + 0.979 * rand(rows, nz), 0.85 * rand(rows, nz)
    emis = torch.full((rows,), 0.95, dtype=torch.float64, device=dev)
    T_col = torch.linspace(290.0, 180.0, nz + 1, dtype=torch.float64, device=dev)
    bpl = eqns.planck_fcn(torch.tensor(2.0e13, dtype=torch.float64, device=dev),
                          T_col).expand(rows, nz + 1).contiguous()
    ang, _ = eqns.zenith_angles_and_weights(4)
    u0s = torch.tensor(np.cos(ang * np.pi / 180.0), device=dev)
    u0 = u0s[torch.arange(rows, device=dev) % 4].contiguous()
    ang12, _ = eqns.zenith_angles_and_weights(12)
    u0s12 = torch.tensor(np.cos(ang12 * np.pi / 180.0), device=dev)
    rs = 0.6 * rand(rows)
    one = torch.ones(1, dtype=torch.float64, device=dev)
    wrappers = {
        "#4 two_stream_ir_auto, hard surface": lambda: twostream_cuda.two_stream_ir_auto(
            tau, w0, gt, emis, True, 1e-6, bpl),
        "#4 two_stream_ir_auto, soft surface": lambda: twostream_cuda.two_stream_ir_auto(
            tau, w0, gt, emis, False, 1e-6, bpl),
        "#4 baseline: #1 at nG = 1, hard surface": lambda: (
            twostream_cuda.two_stream_ir_weighted_cuda(tau, w0, gt, emis, True, 1e-6, bpl, one)),
        "#5 two_stream_solar_multi_auto": lambda: twostream_cuda.two_stream_solar_multi_auto(
            tau, w0, gt, u0s, rs),
        "#5 two_stream_solar_multi_auto, 12 zeniths":
            lambda: twostream_cuda.two_stream_solar_multi_auto(tau, w0, gt, u0s12, rs),
        "#6 two_stream_solar_auto": lambda: twostream_cuda.two_stream_solar_auto(
            tau, w0, gt, u0, rs),
    }
    for label, fn in wrappers.items():
        compare(f"{label} ({rows} x {nz}) float64", built, fn, max(2, args.reps // 2))
        torch.cuda.empty_cache()
    del tau, w0, gt, emis, bpl, rs, wrappers
    torch.cuda.empty_cache()

    # the weighted solar kernel (#2) at the radtran path's shape, amean on
    rows, nz = 65536, 202
    tau = 1e-6 + (2.0 - 1e-6) * rand(rows, nz)
    w0, gt = 0.02 + 0.979 * rand(rows, nz), 0.85 * rand(rows, nz)
    ang, zw = eqns.zenith_angles_and_weights(4)
    sol = (tau, w0, gt, torch.tensor(np.cos(ang * np.pi / 180.0), device=dev), 0.6 * rand(rows),
           torch.tensor(zw, device=dev), wbin)
    compare(f"#2 radtran shape ({rows} x {nz}, 4 zeniths) float64", built,
            lambda: twostream_cuda.two_stream_solar_multi_weighted_cuda(*sol), args.reps,
            twostream.two_stream_solar_multi_weighted(*sol))
    del tau, w0, gt, sol
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
