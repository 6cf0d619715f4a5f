"""Conservative rebinning and spectral regridding: host side (numpy) and the
batched tensor rebin.

These reimplement the semantics of the reference's vendored ``futils``
routines (`rebin`, `inter2`, `addpnt`, `interp_discrete_to_bins`), which
define the opacity-grid semantics of the model (reference usage at
``src/radtran/clima_radtran_types_create.f90:9-78``). They run at data-load
time only. ``rebin`` and ``inter2`` run the native C++ merge sweeps of
``csrc/futils.cpp``, as the JAX package does: the library is built with
``g++ -O3 -shared -fPIC`` into ``clima_tpu_torch/_build/`` on first use and
bound with ``ctypes``. No ``-march=native``, so a library built on one
machine loads on another. A failed build, and a non-zero status from the
library, raise; nothing falls back to numpy. Nothing here runs at import
time. :func:`rebin_jnp` is the batched conservative rebin on tensors, on
any device (its name is the JAX package's, whose traceable form it is).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np
import torch

from ..utils.shared_library import build_shared

__all__ = [
    "rebin",
    "rebin_with_errors",
    "rebin_jnp",
    "inter2",
    "addpnt",
    "interp_discrete_to_bins",
    "grid_at_exact",
]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                    "futils.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB = None
_I64, _DP = ctypes.c_int64, ctypes.POINTER(ctypes.c_double)


def _native_lib():
    """The ctypes library of ``csrc/futils.cpp``, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the native futils library needs a C++ "
                                   "compiler")
            lib = ctypes.CDLL(build_shared(cxx, _FLAGS, _SRC, "libfutils")[0])
            for name in ("clima_rebin", "clima_inter2"):
                fn = getattr(lib, name)
                fn.argtypes = [_I64, _DP, _DP, _I64, _DP, _DP]
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _cptr(arr):
    return arr.ctypes.data_as(_DP)


def _native(name, *args):
    status = getattr(_native_lib(), name)(*args)
    if status != 0:
        raise RuntimeError(f"{name} returned status {status}")


def rebin(old_bins: np.ndarray, old_vals: np.ndarray, new_bins: np.ndarray) -> np.ndarray:
    """Conservatively rebin ``old_vals`` on edges ``old_bins`` to edges ``new_bins``.

    Mirrors futils ``rebin`` as exposed at ``clima/cython/futils.pyx:15-53``:
    the mean of the piecewise-constant function over each new bin; regions
    outside the old grid contribute zero.
    """
    old_bins = np.ascontiguousarray(old_bins, dtype=np.float64)
    old_vals = np.ascontiguousarray(old_vals, dtype=np.float64)
    new_bins = np.ascontiguousarray(new_bins, dtype=np.float64)
    if old_bins.ndim != 1 or new_bins.ndim != 1 or old_vals.ndim != 1:
        raise ValueError("bins and values must be 1-D")
    if len(old_bins) < 2 or len(new_bins) < 2:
        raise ValueError("each grid needs at least one bin")
    if old_vals.shape[-1] != old_bins.shape[0] - 1:
        raise ValueError("old_vals must have len(old_bins)-1 values")
    if np.any(np.diff(old_bins) <= 0) or np.any(np.diff(new_bins) <= 0):
        raise ValueError("bin edges must be strictly increasing")

    out = np.empty(len(new_bins) - 1)
    _native("clima_rebin", len(old_vals), _cptr(old_bins), _cptr(old_vals),
            len(new_bins) - 1, _cptr(new_bins), _cptr(out))
    return out


def rebin_with_errors(old_bins, old_vals, old_errs, new_bins):
    """Conservative rebin propagating independent-bin errors in quadrature.

    Mirrors ``clima/cython/futils.pyx:55-99``. Returns (new_vals, new_errs).
    """
    old_bins = np.asarray(old_bins, dtype=np.float64)
    old_errs = np.asarray(old_errs, dtype=np.float64)
    new_vals = rebin(old_bins, old_vals, new_bins)
    new_bins = np.asarray(new_bins, dtype=np.float64)
    # variance integrates as (overlap/width)**2 * err**2
    n_new = len(new_bins) - 1
    new_errs = np.zeros(n_new)
    for j in range(n_new):
        lo, hi = new_bins[j], new_bins[j + 1]
        over_lo = np.maximum(old_bins[:-1], lo)
        over_hi = np.minimum(old_bins[1:], hi)
        overlap = np.clip(over_hi - over_lo, 0.0, None)
        new_errs[j] = np.sqrt(np.sum((overlap / (hi - lo)) ** 2 * old_errs**2))
    return new_vals, new_errs


def rebin_jnp(old_bins, old_vals, new_bins):
    """Conservative rebin along the last axis, on tensors (any device).

    ``old_bins``: (..., n_old+1) strictly increasing edges; ``old_vals``:
    (..., n_old); ``new_bins``: (n_new+1,) or broadcastable edges. Batched
    ``old_bins``/``old_vals`` give every row its own source grid (as RORR's
    sorted weight edges do). Through the cumulative integral of the
    piecewise-constant source, interpolated at the new edges clipped to the
    source's range: regions outside it contribute zero, as in :func:`rebin`.
    """
    old_bins, old_vals = torch.as_tensor(old_bins), torch.as_tensor(old_vals)
    new_bins = torch.as_tensor(new_bins, dtype=old_bins.dtype, device=old_bins.device)
    F = torch.cat([torch.zeros_like(old_vals[..., :1]),
                   torch.cumsum(old_vals * torch.diff(old_bins, dim=-1), dim=-1)], dim=-1)
    x = torch.minimum(torch.maximum(new_bins, old_bins[..., :1]), old_bins[..., -1:])
    # the interval of each new edge: counts of old edges <= x (compare-all)
    n = old_bins.shape[-1]
    idx = torch.clamp((old_bins[..., None, :] <= x[..., :, None]).sum(dim=-1) - 1, 0, n - 2)
    shape = torch.broadcast_shapes(old_bins.shape[:-1], idx.shape[:-1]) + idx.shape[-1:]
    at = lambda v, i: torch.gather(v.expand(shape[:-1] + v.shape[-1:]), -1, i.expand(shape))
    x0, x1, y0, y1 = at(old_bins, idx), at(old_bins, idx + 1), at(F, idx), at(F, idx + 1)
    Fe = y0 + (x - x0) / torch.where(x1 == x0, torch.ones_like(x1), x1 - x0) * (y1 - y0)
    return torch.diff(Fe, dim=-1) / torch.diff(new_bins, dim=-1)


def addpnt(x: np.ndarray, y: np.ndarray, xnew: float, ynew: float):
    """Insert point (xnew, ynew) keeping x sorted. Mirrors futils ``addpnt``."""
    i = np.searchsorted(x, xnew)
    return np.insert(x, i, xnew), np.insert(y, i, ynew)


def inter2(xg: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Average the piecewise-linear function (x, y) over each bin of edges ``xg``.

    Mirrors futils ``inter2`` used for stellar flux and xsection regridding
    (``clima_radtran_types_create.f90:64,966,1194``): output j is the integral
    of the linear interpolant over [xg[j], xg[j+1]] divided by the bin width.
    The input grid must fully cover ``xg`` (callers guarantee this via addpnt
    sentinel points at 0 and +huge).
    """
    xg = np.ascontiguousarray(xg, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    if xg.ndim != 1 or x.ndim != 1 or y.shape != x.shape:
        raise ValueError("inter2: xg and x must be 1-D, y the shape of x")
    if len(xg) < 2 or len(x) < 2:
        raise ValueError("inter2: each grid needs at least two points")
    if np.any(np.diff(xg) <= 0):
        raise ValueError("inter2: bin edges must be strictly increasing")
    if x[0] > xg[0] or x[-1] < xg[-1]:
        raise ValueError("inter2: data grid does not cover target bins")

    out = np.empty(len(xg) - 1)
    _native("clima_inter2", len(xg) - 1, _cptr(xg), _cptr(out), len(x), _cptr(x), _cptr(y))
    return out


def interp_discrete_to_bins(bin_edges, xp, yp, extrapolation="Constant", fill_value=None):
    """Regrid discrete samples (xp, yp) onto bins, futils ``interp_discrete_to_bins``.

    Used for Mie particle optical data ('Constant') and photolysis xsections
    ('FillValue') at ``clima_radtran_types_create.f90:832-841,1461``.

    The value in each bin is the average of the linear interpolant of the
    samples over the bin. Out-of-range regions use constant end-value
    extrapolation ('Constant') or ``fill_value`` ('FillValue').
    """
    bin_edges = np.asarray(bin_edges, dtype=np.float64)
    xp = np.asarray(xp, dtype=np.float64)
    yp = np.asarray(yp, dtype=np.float64)
    order = np.argsort(xp)
    xp = xp[order]
    yp = yp[order]
    if extrapolation == "Constant":
        lo_val, hi_val = yp[0], yp[-1]
    elif extrapolation == "FillValue":
        if fill_value is None:
            raise ValueError("fill_value required for FillValue extrapolation")
        lo_val = hi_val = fill_value
    else:
        raise ValueError(f"unknown extrapolation {extrapolation!r}")
    eps = 1e-10 * max(abs(xp[0]), 1.0)
    x = np.concatenate([[min(bin_edges[0], xp[0]) - 1.0, xp[0] - eps], xp,
                        [xp[-1] + eps, max(bin_edges[-1], xp[-1]) + 1.0]])
    y = np.concatenate([[lo_val, lo_val], yp, [hi_val, hi_val]])
    return inter2(bin_edges, x, y)


def grid_at_exact(n, lo, hi):
    """``n`` points from ``lo`` to ``hi`` (futils ``linspace``) with both
    endpoints exactly ``lo`` and ``hi``."""
    g = np.linspace(lo, hi, n)
    g[0] = lo
    g[-1] = hi
    return g
