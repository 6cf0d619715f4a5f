"""Plain reference: the opacity tables, channels and stellar flux derived from
a synthetic data tree, in float64 numpy.

An independent copy of the load-time regridding that Clima does in
``clima_radtran_types_create.f90`` (k-tables :1265-1378, CIA and continuum
:868-1263, Rayleigh :1048-1088, photolysis :1407-1468, Mie :734-866, channels
:226-270, stellar flux :9-78), written from the port's plain paths with the
native regrid replaced by its numpy form. It reads only the tree (a mapping
from relative path to content, as ``synthetic.synthetic_datadir`` builds it)
and the settings document, and imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["OpticalTables", "load_tables", "stellar_flux", "zenith_angles_and_weights"]

C_LIGHT = 299792458.0
LOG10TINY = math.log10(math.sqrt(2.2250738585072014e-308))
RDELTA = 1.0e-4
HUGE = 1.0e30


def addpnt(x, y, xnew, ynew):
    i = np.searchsorted(x, xnew)
    return np.insert(x, i, xnew), np.insert(y, i, ynew)


def inter2(xg, x, y):
    """Mean of the piecewise-linear (x, y) over each bin of edges xg, through
    its cumulative integral."""
    seg = 0.5 * (y[1:] + y[:-1]) * np.diff(x)
    F = np.concatenate([[0.0], np.cumsum(seg)])
    idx = np.clip(np.searchsorted(x, xg, side="right") - 1, 0, len(x) - 2)
    x0, x1, y0, y1 = x[idx], x[idx + 1], y[idx], y[idx + 1]
    t = np.where(x1 > x0, (xg - x0) / np.where(x1 == x0, 1.0, x1 - x0), 0.0)
    Fe = F[idx] + 0.5 * (y0 + (y0 + t * (y1 - y0))) * (xg - x0)
    return np.diff(Fe) / np.diff(xg)


def _sentinels(x, y, fill):
    x, y = addpnt(x, y, x[0] * (1.0 - RDELTA), fill)
    x, y = addpnt(x, y, 0.0, fill)
    x, y = addpnt(x, y, x[-1] * (1.0 + RDELTA), fill)
    return addpnt(x, y, HUGE, fill)


def _regrid_rows(wavl, wav_nm, rows, fill=LOG10TINY):
    return np.stack([inter2(wavl, *_sentinels(wav_nm.copy(), r.copy(), fill)) for r in rows])


def _discrete_to_bins(edges, xp, yp, fill=None):
    """Bin means of the linear interpolant of samples, constant end values
    outside them, or ``fill`` where given."""
    order = np.argsort(xp)
    xp, yp = xp[order], yp[order]
    lo, hi = (yp[0], yp[-1]) if fill is None else (fill, fill)
    eps = 1e-10 * max(abs(xp[0]), 1.0)
    x = np.concatenate([[min(edges[0], xp[0]) - 1.0, xp[0] - eps], xp,
                        [xp[-1] + eps, max(edges[-1], xp[-1]) + 1.0]])
    y = np.concatenate([[lo, lo], yp, [hi, hi]])
    return inter2(edges, x, y)


def _vardavas(A, B, Delta, lam_nm):
    lam_um = lam_nm * 1.0e-3
    return (4.577e-21 * ((6.0 + 3.0 * Delta) / (6.0 - 7.0 * Delta))
            * (A * (1.0 + B / lam_um**2)) ** 2 * (1.0 / lam_um**4))


def zenith_angles_and_weights(n):
    """Gauss-Legendre zenith cosines and weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    angles = np.arccos(x / 2.0 + 0.5) * 180.0 / np.pi
    return np.cos(angles * np.pi / 180.0), w / 2.0


class OpticalTables:
    """Every table the opacity needs, numpy float64 on the master grid.

    ``k``: [(species index, log10P, T, log10k (G, P, T, W))]; ``cia``:
    [(j, jj, T, log10xs (T, W))]; ``ray`` and ``pxs``: [(j, xs (W,))];
    ``part``: [(particle index, radii cm, w0, qext, g (R, W))]; ``cont``:
    None or (LH2O, T, log10 H2O, log10 foreign); ``wbin`` (G,), ``wavl`` and
    ``freq`` (W+1,); ``ir`` and ``sol``: (first bin, last bin) of each channel.
    """


def load_tables(tree, gases, particles, opacities):
    """The tables of ``opacities`` (the settings' ``optical-properties/
    opacities`` mapping) for the species ``gases`` and ``particles``."""
    t = OpticalTables()
    h5 = lambda rel: {k: np.asarray(v, dtype=np.float64) for k, v in tree[rel].items()}
    continuum = opacities.get("water-continuum")

    t.k = []
    for j, s in enumerate(gases):
        rel = f"kdistributions/{s}.h5"
        if rel in tree:
            f = h5(rel)
            t.k.append((j, f["log10P"], f["T"], f["log10k"]))
            t.wbin = f["weights"]
            wavl = f["wavelengths"] * 1.0e3
    t.wavl, t.freq = wavl, C_LIGHT / (wavl * 1.0e-9)

    t.cia = []
    if opacities.get("CIA"):
        for j, s1 in enumerate(gases):
            for jj, s2 in enumerate(gases):
                rel = f"CIA/{s1}-{s2}.h5"
                if rel in tree and not (continuum and "H2O" in (s1, s2)):
                    f = h5(rel)
                    t.cia.append((j, jj, f["T"], _regrid_rows(wavl, f["wavelengths"] * 1.0e3,
                                                               f["log10xs"])))
    t.ray = []
    if opacities.get("rayleigh"):
        for s, d in tree["rayleigh/rayleigh.yaml"].items():
            if s in gases:
                d = d["data"]
                t.ray.append((gases.index(s), _vardavas(d["A"], d["B"], d["Delta"], wavl[:-1])))
    t.pxs = []
    if opacities.get("photolysis-xs"):
        for j, s in enumerate(gases):
            rel = f"xsections/{s}.h5"
            if rel in tree:
                f = h5(rel)
                lg = np.log10(np.maximum(f["photoabsorption"], 1e-300))
                t.pxs.append((j, 10.0 ** _discrete_to_bins(wavl, f["wavelengths"], lg,
                                                          LOG10TINY)))
    t.part = []
    for p in opacities.get("particle-xs") or []:
        f = h5(f"aerosol_xsections/{p['data']}/mie_{p['data']}.h5")
        wv = f["wavelengths"] * 1.0e3
        reg = lambda key: np.stack([_discrete_to_bins(wavl, wv, row) for row in f[key]])
        t.part.append((particles.index(p["name"]), f["radii"] / 1.0e4, reg("w0"), reg("qext"),
                       reg("g0")))
    t.cont = None
    if continuum:
        f = h5(f"water_continuum/{continuum}.h5")
        wv = f["wavelengths"] * 1.0e3
        t.cont = (gases.index("H2O"), f["T"], _regrid_rows(wavl, wv, f["log10xs_H2O"]),
                  _regrid_rows(wavl, wv, f["log10xs_foreign"]))

    bins = h5("kdistributions/bins.h5")
    channel = lambda key: (int(np.argmin(np.abs(bins[key][0] * 1e3 - wavl))),
                           int(np.argmin(np.abs(bins[key][-1] * 1e3 - wavl))) - 1)
    t.ir, t.sol = channel("ir_wavl"), channel("sol_wavl")
    return t


def stellar_flux(star, wavl):
    """Per-bin stellar flux, mW/m^2/Hz, from a (wavelength nm, mW/m^2/nm) table."""
    wv, fl = np.asarray(star[:, 0], np.float64), np.asarray(star[:, 1], np.float64)
    flux = inter2(wavl, *_sentinels(wv, fl, 0.0))
    av = 0.5 * (wavl[:-1] + wavl[1:])
    return flux * (((av * 1.0e-9) * av) / C_LIGHT)
