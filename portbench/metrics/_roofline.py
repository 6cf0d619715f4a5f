"""Operations and bytes of the port's kernels, and the H100's published peaks.

A frozen copy of the counts of the port's roofline tool: from shapes alone,
each kernel's compulsory bytes (every input read once, every output written
once) and its float64 operations, and the least time the card could take for
them (:func:`bound`). The benchmark keeps its own copy so that the yardstick
does not move when the program's tool changes.
"""

from __future__ import annotations

import math

__all__ = ["HBM_BYTES_PER_S", "FP64_OPS_PER_S", "F64", "bound", "twostream_ops",
           "ir_weighted_work", "solar_weighted_work", "rorr_work", "opacity_work"]

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor-core FP64 peak
HBM_BYTES_PER_S, FP64_OPS_PER_S = 3.35e12, 34e12
F64 = 8


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for ``nbytes`` of
    memory traffic and ``ops`` float64 operations, and which one sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def twostream_ops(solar, nzen=1, amean=False):
    """Float64 operations per (row, layer) of a two-stream solve (exp, sqrt
    and a divide count as one each; the pass-3 recomputation is not
    counted): layer coefficients, the 2x2-block elimination, back
    substitution and the edge fluxes. Solar: 25 shared + 25 per zenith for
    the coefficients and sources, 25 for the elimination, 28 per zenith for
    elimination, back substitution and fluxes, +10 per zenith for amean."""
    if not solar:
        return 30 + 25 + 12 + 4 + 12
    return 25 + 25 * nzen + 25 + nzen * (28 + (10 if amean else 0))


def ir_weighted_work(rows, nz, nG, itemsize=F64):
    """#1, the weighted IR kernel: tau, w0, gt (rows, nz), emissivity (rows,),
    bplanck (rows, nz+1) and wbin (nG,) in; fup, fdn (rows/nG, nz+1) out.
    Returns (bytes, operations)."""
    nbytes = itemsize * (3 * rows * nz + rows + rows * (nz + 1) + nG
                         + 2 * (rows // nG) * (nz + 1))
    return nbytes, rows * nz * twostream_ops(False)


def solar_weighted_work(rows, nz, nzen, nG, amean=False, itemsize=F64):
    """#2, the weighted solar kernel: tau, w0, gt (rows, nz), Rsfc (rows,),
    u0s and zw (nzen,), wbin (nG,) in; fup, fdn and, with ``amean``, amean
    (rows/nG, nz+1) out."""
    outputs = 3 if amean else 2
    nbytes = itemsize * (3 * rows * nz + rows + 2 * nzen + nG
                         + outputs * (rows // nG) * (nz + 1))
    return nbytes, rows * nz * twostream_ops(True, nzen, amean)


def rorr_work(R, nbin, nk=3, itemsize=F64):
    """#3, RORR: tau (nk, nbin, R), wbin (nbin,) and wbin_e (nbin+1,) in,
    (nbin, R) out. Per lane and species pair, nbin^2 key sums, a sort of the
    nbin^2 keys (n log2 n compares), the weight prefix sum and the overlap
    rebin (~2 operations per key)."""
    npair = nbin * nbin
    nbytes = itemsize * (nk * nbin * R + nbin * R + 2 * nbin + 1)
    return nbytes, (nk - 1) * R * npair * (1 + math.log2(npair) + 1 + 2)


def opacity_work(columns, nz, nw, nbin, ng, nk, itemsize=F64):
    """``compute_opacity``: P, T, dz (columns, nz) and densities (columns,
    nz, ng) in; tau, w0 (columns, nw, nbin, nz) and g, tau_band (columns, nw,
    nz) out (the tables are not counted). Operations:
    the k-table interpolation of each species, the RORR chain and ~5 per
    (bin, gauss, layer) to combine the continua and form w0 and tau_band."""
    nbytes = itemsize * (columns * (2 * nw * nbin * nz + 2 * nw * nz)
                         + columns * nz * (ng + 3))
    lanes = columns * nw * nz
    ops = nk * nbin * lanes * (2 * 4 + 1 + 1) + rorr_work(lanes, nbin, nk)[1] \
        + 5 * nbin * lanes
    return nbytes, ops
