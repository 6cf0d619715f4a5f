"""Table interpolation primitives on tensors.

Replaces the reference's vendored ``finterp`` objects (used throughout
``src/radtran/clima_radtran_types.f90:890-983`` for k-table, xsection and
particle interpolation) with hat-basis weights: every table lookup becomes a
small dense contraction instead of a gather.
"""

from __future__ import annotations

import torch

__all__ = ["hat_weights", "pdot", "searchsorted_right"]


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
