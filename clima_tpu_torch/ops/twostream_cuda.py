"""Two-stream solves: CUDA kernels (``csrc/twostream.cu``) and their dispatch.

Replaces the five Pallas TPU kernels of ``clima_tpu/ops/pallas_twostream.py``:
the weight-fused ``two_stream_ir_weighted_pallas`` and
``two_stream_solar_multi_weighted_pallas`` (the radiate module's path), and
the unreduced ``two_stream_ir_pallas``, ``two_stream_solar_multi_pallas`` and
``two_stream_solar_pallas``, which the JAX package reaches through its
dispatchers ``two_stream_{ir,solar_multi,solar}_auto``; the wrappers of the
unreduced kernels carry those names and signatures here. Each wrapper runs
the plain PyTorch twin (:mod:`.twostream`, the same math as the JAX package's
XLA path, solved by block PCR) for tensors on the CPU, and launches the kernel
for tensors on a CUDA device; there is no fallback between the two.

What bounds the kernels on an H100, and what the design does about it, is
described at the top of ``csrc/twostream.cu``: one thread per (column, bin,
gauss) row runs a 2x2-block Thomas elimination down the column and back.
The weighted kernels sum zeniths in registers and gauss points in shared
memory, with no atomics, so the (rows, nz+1) per-row fluxes never reach
device memory; the unreduced kernels store each row's fluxes.

``launches`` on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import torch

from . import twostream as ts
from .cuda_build import load_library

__all__ = ["two_stream_ir_weighted_cuda", "two_stream_solar_multi_weighted_cuda",
           "two_stream_ir_auto", "two_stream_solar_multi_auto", "two_stream_solar_auto"]


def _check(tensors, dtype, device):
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernels take float32 or float64, not {dtype}")


def _launch(solar, with_amean, tau, w0, gt, surf, bpl, u0s, zw, wbin, hard, tau_min):
    rows, nz = tau.shape
    nG = wbin.shape[0]
    nzen = u0s.shape[0] if solar else 1
    if w0.shape != tau.shape or gt.shape != tau.shape or surf.shape != (rows,):
        raise ValueError("tau/w0/gt must be (rows, nz) and the surface term (rows,)")
    if (bpl is not None and bpl.shape != (rows, nz + 1)) or (solar and zw.shape != u0s.shape):
        raise ValueError("bplanck must be (rows, nz+1) and zw match u0s")
    if not (1 <= nG <= 1024) or rows % nG:
        raise ValueError(f"rows ({rows}) must be whole gauss groups of 1..1024 (nG={nG})")
    if not 1 <= nzen <= 8:
        raise ValueError(f"the solar kernel takes 1..8 zenith angles, not {nzen}")
    nrhs = 1 if not solar else (4 if nzen <= 4 else 8)
    kw = dict(dtype=tau.dtype, device=tau.device)
    scratch = torch.empty((nz, 2 + 2 * nrhs, rows), **kw)
    outs = [torch.empty((rows // nG, nz + 1), **kw) for _ in range(3 if with_amean else 2)]
    am = outs[2].data_ptr() if with_amean else None
    fn = load_library("twostream")["clima_twostream_weighted"]
    status = fn(int(tau.dtype == torch.float64), int(solar), int(with_amean),
                tau.data_ptr(), w0.data_ptr(), gt.data_ptr(), surf.data_ptr(),
                bpl.data_ptr() if bpl is not None else None,
                u0s.data_ptr() if solar else None, zw.data_ptr() if solar else None, nzen,
                wbin.data_ptr(), nG, rows, nz, int(hard), float(tau_min),
                scratch.data_ptr(), am, outs[0].data_ptr(), outs[1].data_ptr(),
                torch.cuda.current_stream(tau.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"two-stream kernel launch failed: CUDA error {status}")
    return (outs[2] if with_amean else None), outs[0], outs[1]


def two_stream_ir_weighted_cuda(tau, w0, gt, emissivity, has_hard_surface, tau_min,
                                bplanck, wbin):
    """IR two-stream with the gauss-weight reduction fused.

    tau/w0/gt (rows, nz) group-major (rows = groups*nG), emissivity (rows,),
    bplanck (rows, nz+1), wbin (nG,). Returns (fup_w, fdn_w), each
    (groups, nz+1), TOA-down. Twin: :func:`.twostream.two_stream_ir_weighted`.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_ir_weighted(tau, w0, gt, emissivity, has_hard_surface,
                                         tau_min, bplanck, wbin)
    if tau.device.type != "cuda":
        raise ValueError(f"no two-stream kernel for device {tau.device}")
    _check(dict(tau=tau, w0=w0, gt=gt, emissivity=emissivity, bplanck=bplanck, wbin=wbin),
           tau.dtype, tau.device)
    _, fup, fdn = _launch(False, False, tau, w0, gt, emissivity, bplanck, None, None, wbin,
                          has_hard_surface, tau_min)
    two_stream_ir_weighted_cuda.launches += 1
    return fup, fdn


two_stream_ir_weighted_cuda.launches = 0


def two_stream_solar_multi_weighted_cuda(tau, w0, gt, u0s, Rsfc, zw, wbin, with_amean=True):
    """Multi-zenith solar two-stream with the zenith- and gauss-weight
    reductions fused.

    tau/w0/gt (rows, nz) group-major, u0s/zw (nzen,), Rsfc (rows,), wbin
    (nG,). Returns (am_w, fup_w, fdn_w), each (groups, nz+1), TOA-down;
    am_w is None when ``with_amean`` is False (the kernel then skips it).
    Twin: :func:`.twostream.two_stream_solar_multi_weighted`.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_solar_multi_weighted(tau, w0, gt, u0s, Rsfc, zw, wbin,
                                                  with_amean=with_amean)
    if tau.device.type != "cuda":
        raise ValueError(f"no two-stream kernel for device {tau.device}")
    _check(dict(tau=tau, w0=w0, gt=gt, u0s=u0s, Rsfc=Rsfc, zw=zw, wbin=wbin),
           tau.dtype, tau.device)
    out = _launch(True, with_amean, tau, w0, gt, Rsfc, None, u0s, zw, wbin, False, 0.0)
    two_stream_solar_multi_weighted_cuda.launches += 1
    return out


two_stream_solar_multi_weighted_cuda.launches = 0


def _launch_rows(solar, tau, w0, gt, surf, bpl, u0, u0_per_row, hard, tau_min):
    """Unreduced kernel: IR returns (fup, fdn), each (rows, nz+1); solar
    returns (amean, srad, fup, fdn) with a leading nzen axis (1 for u0 per row)."""
    rows, nz = tau.shape
    nzen = 1 if (not solar or u0_per_row) else u0.shape[0]
    if w0.shape != tau.shape or gt.shape != tau.shape or surf.shape != (rows,):
        raise ValueError("tau/w0/gt must be (rows, nz) and the surface term (rows,)")
    if bpl is not None and bpl.shape != (rows, nz + 1):
        raise ValueError("bplanck must be (rows, nz+1)")
    if solar and u0_per_row and u0.shape != (rows,):
        raise ValueError("u0 must be (rows,)")
    if solar and not 1 <= nzen <= 8:
        raise ValueError(f"the solar kernel takes 1..8 zenith angles, not {nzen}")
    # right-hand sides of the instantiation: 1 (IR, u0 per row), 4 or 8
    nrhs = 1 if (not solar or u0_per_row) else (4 if nzen <= 4 else 8)
    kw = dict(dtype=tau.dtype, device=tau.device)
    scratch = torch.empty((nz, 2 + 2 * nrhs, rows), **kw)
    fup = torch.empty((nzen, rows, nz + 1), **kw)
    fdn = torch.empty((nzen, rows, nz + 1), **kw)
    am = torch.empty((nzen, rows, nz + 1), **kw) if solar else None
    srad = torch.empty((nzen, rows), **kw) if solar else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    fn = load_library("twostream")["clima_twostream_rows"]
    status = fn(int(tau.dtype == torch.float64), int(solar), int(u0_per_row),
                tau.data_ptr(), w0.data_ptr(), gt.data_ptr(), surf.data_ptr(), ptr(bpl),
                ptr(u0), nzen, rows, nz, int(hard), float(tau_min), scratch.data_ptr(),
                ptr(am), fup.data_ptr(), fdn.data_ptr(), ptr(srad),
                torch.cuda.current_stream(tau.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"two-stream kernel launch failed: CUDA error {status}")
    if not solar:
        return fup[0], fdn[0]
    return am, srad, fup, fdn


def _device_checked(tensors):
    tau = tensors["tau"]
    if tau.device.type != "cuda":
        raise ValueError(f"no two-stream kernel for device {tau.device}")
    if tau.ndim != 2:
        raise ValueError(f"the kernels take a 2-D (rows, nz) batch, not {tuple(tau.shape)}")
    _check(tensors, tau.dtype, tau.device)


def two_stream_ir_auto(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck):
    """IR two-stream per row (JAX ``ops.twostream.two_stream_ir_auto``).

    tau/w0/gt (rows, nz) TOA-down, emissivity (rows,), bplanck (rows, nz+1);
    ``tau_min`` a float. Returns (fup, fdn), each (rows, nz+1).
    Twin: :func:`.twostream.two_stream_ir`.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_ir(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck)
    if not isinstance(tau_min, (int, float)):
        raise TypeError("tau_min must be a Python float for the kernel")
    _device_checked(dict(tau=tau, w0=w0, gt=gt, emissivity=emissivity, bplanck=bplanck))
    out = _launch_rows(False, tau, w0, gt, emissivity, bplanck, None, False,
                       has_hard_surface, tau_min)
    two_stream_ir_auto.launches += 1
    return out


two_stream_ir_auto.launches = 0


def two_stream_solar_multi_auto(tau, w0, gt, u0s, Rsfc):
    """Multi-zenith solar two-stream per row (JAX
    ``ops.twostream.two_stream_solar_multi_auto``).

    tau/w0/gt (rows, nz) TOA-down, u0s (nzen,) shared by all rows (nzen <= 8
    on the card), Rsfc (rows,). Returns (amean, surface_radiance, fup, fdn):
    amean/fup/fdn (nzen, rows, nz+1), surface_radiance (nzen, rows).
    Twin: :func:`.twostream.two_stream_solar_multi`.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_solar_multi(tau, w0, gt, u0s, Rsfc)
    _device_checked(dict(tau=tau, w0=w0, gt=gt, u0s=u0s, Rsfc=Rsfc))
    out = _launch_rows(True, tau, w0, gt, Rsfc, None, u0s, False, False, 0.0)
    two_stream_solar_multi_auto.launches += 1
    return out


two_stream_solar_multi_auto.launches = 0


def two_stream_solar_auto(tau, w0, gt, u0, Rsfc):
    """Single-zenith solar two-stream with one zenith cosine per row (JAX
    ``ops.twostream.two_stream_solar_auto``).

    tau/w0/gt (rows, nz) TOA-down, u0 (rows,), Rsfc (rows,). Returns
    (amean, surface_radiance, fup, fdn): amean/fup/fdn (rows, nz+1),
    surface_radiance (rows,). Twin: :func:`.twostream.two_stream_solar`.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_solar(tau, w0, gt, u0, Rsfc)
    _device_checked(dict(tau=tau, w0=w0, gt=gt, u0=u0, Rsfc=Rsfc))
    am, srad, fup, fdn = _launch_rows(True, tau, w0, gt, Rsfc, None, u0, True, False, 0.0)
    two_stream_solar_auto.launches += 1
    return am[0], srad[0], fup[0], fdn[0]


two_stream_solar_auto.launches = 0
