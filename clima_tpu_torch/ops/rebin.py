"""Conservative rebinning and spectral regridding, host side (numpy).

These reimplement the semantics of the reference's vendored ``futils``
routines (`rebin`, `inter2`, `addpnt`, `interp_discrete_to_bins`), which
define the opacity-grid semantics of the model (reference usage at
``src/radtran/clima_radtran_types_create.f90:9-78``). They run at data-load
time only. The conservative rebin is formulated through the cumulative
integral of the piecewise-constant source function.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rebin", "inter2", "addpnt", "interp_discrete_to_bins"]


def rebin(old_bins: np.ndarray, old_vals: np.ndarray, new_bins: np.ndarray) -> np.ndarray:
    """Conservatively rebin ``old_vals`` on edges ``old_bins`` to edges ``new_bins``.

    Mirrors futils ``rebin`` as exposed at ``clima/cython/futils.pyx:15-53``:
    the mean of the piecewise-constant function over each new bin; regions
    outside the old grid contribute zero.
    """
    old_bins = np.ascontiguousarray(old_bins, dtype=np.float64)
    old_vals = np.ascontiguousarray(old_vals, dtype=np.float64)
    new_bins = np.ascontiguousarray(new_bins, dtype=np.float64)
    if old_bins.ndim != 1 or new_bins.ndim != 1:
        raise ValueError("bins must be 1-D")
    if old_vals.shape[-1] != old_bins.shape[0] - 1:
        raise ValueError("old_vals must have len(old_bins)-1 values")
    if np.any(np.diff(old_bins) <= 0) or np.any(np.diff(new_bins) <= 0):
        raise ValueError("bin edges must be strictly increasing")

    widths = old_bins[1:] - old_bins[:-1]
    F = np.concatenate([np.zeros(old_vals.shape[:-1] + (1,)),
                        np.cumsum(old_vals * widths, axis=-1)], axis=-1)
    Fe = np.interp(np.clip(new_bins, old_bins[0], old_bins[-1]), old_bins, F)
    return np.diff(Fe) / np.diff(new_bins)


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
    if x[0] > xg[0] or x[-1] < xg[-1]:
        raise ValueError("inter2: data grid does not cover target bins")

    # cumulative integral of the piecewise-linear function at points x
    seg = 0.5 * (y[1:] + y[:-1]) * np.diff(x)
    F = np.concatenate([[0.0], np.cumsum(seg)])

    def cumint(pts):
        idx = np.clip(np.searchsorted(x, pts, side="right") - 1, 0, len(x) - 2)
        x0 = x[idx]
        x1 = x[idx + 1]
        y0 = y[idx]
        y1 = y[idx + 1]
        t = np.where(x1 > x0, (pts - x0) / np.where(x1 == x0, 1.0, x1 - x0), 0.0)
        yq = y0 + t * (y1 - y0)
        return F[idx] + 0.5 * (y0 + yq) * (pts - x0)

    Fe = cumint(xg)
    return np.diff(Fe) / np.diff(xg)


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
