"""Table interpolation primitives on tensors.

Replaces the reference's vendored ``finterp`` objects (used throughout
``src/radtran/clima_radtran_types.f90:890-983`` for k-table, xsection and
particle interpolation) with hat-basis weights: every table lookup becomes a
small dense contraction instead of a gather. :func:`interp1d` and
:func:`interp2d` are the gather forms, with finterp's linear extrapolation
past the edges.
"""

from __future__ import annotations

import torch

__all__ = ["interp1d", "interp2d", "searchsorted_right", "hat_weights", "pdot"]


def pdot(a, b):
    """Matmul for precision-critical contractions, in the operands' full precision.

    Interpolation weights and weighted flux reductions must not drop to TF32
    on the GPU: that quantization staircases the RCE residual as a function
    of temperature. float32 products therefore refuse to run unless
    ``torch.backends.cuda.matmul.allow_tf32`` is off (PyTorch's default).
    """
    if a.dtype == torch.float32 and a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "float32 pdot needs torch.backends.cuda.matmul.allow_tf32 = False"
        )
    return torch.matmul(a, b)


def hat_weights(grid, x):
    """Linear-interpolation hat-basis weights, gather-free.

    Returns W of shape ``x.shape + (len(grid),)`` with two adjacent nonzeros
    per sample such that ``W @ values == interp(x, grid, values)`` for ``x``
    clamped to the grid range. ``grid`` is a 1-D tensor on ``x``'s device.
    """
    xc = torch.clamp(x, grid[0], grid[-1])[..., None]
    # boundary nodes get a virtual outer neighbor so their half-hat is flat
    gl = torch.cat([grid[:1] - 1.0, grid[:-1]])  # left neighbors
    gr = torch.cat([grid[1:], grid[-1:] + 1.0])  # right neighbors
    up = (xc - gl) / (grid - gl)  # rising edge of the hat
    down = (gr - xc) / (gr - grid)  # falling edge
    w = torch.clamp(torch.minimum(up, down), 0.0, 1.0)
    # normalize to guard the sample-exactly-on-a-node double count
    return w / torch.sum(w, dim=-1, keepdim=True)


def searchsorted_right(xs, x):
    """Index of the interval containing x: clip(searchsorted(xs, x, 'right')-1, 0, n-2)."""
    n = xs.shape[-1]
    return torch.clamp(torch.searchsorted(xs, x, right=True) - 1, 0, n - 2)


def interp1d(x, xs, ys):
    """Linear interpolation of ys(xs) at x; linear extrapolation at the edges.

    ``xs``: (n,) sorted 1-D grid. ``ys``: (..., n) values (leading dims are
    table batch dims, e.g. wavelength bins). ``x``: a number or a tensor that
    broadcasts against ys' leading dims; ``result[...]`` uses the x of the
    same leading position.
    """
    xs, ys = torch.as_tensor(xs), torch.as_tensor(ys)
    x = torch.as_tensor(x, dtype=ys.dtype, device=ys.device)
    idx = searchsorted_right(xs, x.contiguous())
    x0, x1 = xs[idx], xs[idx + 1]
    if ys.ndim > 1:
        shape = torch.broadcast_shapes(ys.shape[:-1], idx.shape)
        table = ys.expand(shape + ys.shape[-1:])
        take = lambda i: torch.gather(table, -1, i.expand(shape)[..., None])[..., 0]
        y0, y1 = take(idx), take(idx + 1)
    else:
        y0, y1 = ys[idx], ys[idx + 1]
    t = (x - x0) / (x1 - x0)
    return y0 + t * (y1 - y0)


def interp2d(x, y, xs, ys, table):
    """Bilinear interpolation of table(xs, ys) at points (x, y), linear
    extrapolation past the edges.

    ``xs``: (nx,), ``ys``: (ny,) sorted grids; ``table``: (..., nx, ny).
    ``x``/``y``: numbers or tensors broadcastable with each other; the result
    broadcasts the table's batch dims against the points' dims (k-table
    evaluation, log10k[(gauss, bin)](log10P, T), clima_radtran_types.f90:
    649-662).
    """
    xs, ys, table = torch.as_tensor(xs), torch.as_tensor(ys), torch.as_tensor(table)
    x = torch.as_tensor(x, dtype=table.dtype, device=table.device)
    y = torch.as_tensor(y, dtype=table.dtype, device=table.device)
    ix, iy = searchsorted_right(xs, x.contiguous()), searchsorted_right(ys, y.contiguous())
    tx = (x - xs[ix]) / (xs[ix + 1] - xs[ix])
    ty = (y - ys[iy]) / (ys[iy + 1] - ys[iy])
    flat = table.reshape(table.shape[:-2] + (-1,))

    def at(i, j):
        lin = i * table.shape[-1] + j
        if lin.ndim == 0:
            return flat[..., lin]
        shape = torch.broadcast_shapes(flat.shape[:-1], lin.shape)
        return torch.gather(flat.expand(shape + flat.shape[-1:]), -1,
                            lin.expand(shape)[..., None])[..., 0]

    return (at(ix, iy) * (1 - tx) * (1 - ty) + at(ix + 1, iy) * tx * (1 - ty)
            + at(ix, iy + 1) * (1 - tx) * ty + at(ix + 1, iy + 1) * tx * ty)
