"""Dry prescribed-profile construction (``src/adiabat/clima_adiabat_dry.f90``),
batched over columns.

User supplies P/T/mixing-ratio columns; they are interpolated onto the
internal 2*nz+1 log-P grid and only the hydrostatic altitude is integrated.
The recorded ``lapse_rate`` is the local dry adiabat R/cp (dry.f90:275-308).
Mirrors ``clima_tpu/adiabat/profile_dry.py``.
"""

from __future__ import annotations

import torch

from .. import constants as const
from ..config.species import heat_capacity
from ..ops.interp import searchsorted_right
from .profile import AdiabatParams, _linspace

__all__ = ["make_profile_dry_core"]


def _interp_rows(xs, ys, x):
    """Linear interpolation in ascending grids xs (B, n) of ys (B, n, m) at
    x (B, k) -> (B, k, m), linear extrapolation at the ends."""
    idx = searchsorted_right(xs, x)  # (B, k)
    x0, x1 = torch.gather(xs, 1, idx), torch.gather(xs, 1, idx + 1)
    t = ((x - x0) / (x1 - x0))[..., None]
    m = ys.shape[-1]
    y0 = torch.gather(ys, 1, idx[..., None].expand(-1, -1, m))
    y1 = torch.gather(ys, 1, (idx + 1)[..., None].expand(-1, -1, m))
    return y0 + t * (y1 - y0)


def make_profile_dry_core(par: AdiabatParams, P_in, T_in, f_i_in):
    """Build the dry profiles. P_in (B, npts) decreasing (surface first), T_in
    (B, npts), f_i_in (B, npts, ng). Returns a dict of (B, ...) edge arrays:
    P_e, T_e, z_e (B, 2nz+1), f_i_e (B, 2nz+1, ng), lapse_rate_e (B, 2nz+1)."""
    ne = 2 * par.nz + 1

    # normalize mixing ratios (dry.f90:117-121)
    f_norm = f_i_in / torch.sum(f_i_in, dim=2, keepdim=True)

    P_surf = P_in[:, 0]
    P_top = torch.full_like(P_surf, par.P_top)
    P_e = 10.0 ** _linspace(torch.log10(P_surf), torch.log10(P_top), ne)
    P_e = torch.cat([P_surf[:, None], P_e[:, 1:-1], P_top[:, None]], dim=-1)

    lg_in = torch.flip(torch.log10(P_in), dims=[1])  # ascending
    T_grid = torch.flip(T_in, dims=[1])
    lf_grid = torch.flip(torch.log10(torch.clamp(f_norm, min=1e-200)), dims=[1])  # (B, npts, ng)
    # T and log10 f share one interpolation
    grid = torch.cat([T_grid[..., None], lf_grid], dim=-1)

    def at(lgP):
        """(T, f_i) at log10 pressures lgP (B, k): (B, k) and (B, k, ng)."""
        v = _interp_rows(lg_in, grid, lgP)
        return v[..., 0], 10.0 ** v[..., 1:]

    T_e, f_i_e = at(torch.log10(P_e))

    # dry adiabat lapse rate R/cp at each level (dry.f90:275-308)
    cp = torch.sum(heat_capacity(par.thermo, T_e) * f_i_e, dim=-1)
    lapse_rate_e = const.Rgas_si / cp

    # hydrostatic z
    GM = const.G_grav * (par.planet_mass / 1.0e3)

    def rhs(Pv, zv):
        Tv, fv = at(torch.log10(Pv)[:, None])
        muv = torch.sum(fv[:, 0] * par.gas_masses, dim=-1)
        grav = GM / ((par.planet_radius + zv) / 1.0e2) ** 2 * 1.0e2
        return -(const.Rgas * Tv[:, 0]) / (grav * Pv * muv)

    K = par.substeps
    z = torch.zeros_like(P_surf)
    zs = [z]
    for i in range(ne - 1):
        la, lb = torch.log(P_e[:, i]), torch.log(P_e[:, i + 1])
        for k in range(K):
            p0 = torch.exp(la + (lb - la) * k / K)
            p1 = torch.exp(la + (lb - la) * (k + 1) / K)
            h = p1 - p0
            k1 = rhs(p0, z)
            k2 = rhs(p0 + 0.5 * h, z + 0.5 * h * k1)
            k3 = rhs(p0 + 0.5 * h, z + 0.5 * h * k2)
            k4 = rhs(p1, z + h * k3)
            z = z + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        zs.append(z)

    return dict(P_e=P_e, T_e=T_e, z_e=torch.stack(zs, dim=1), f_i_e=f_i_e,
                lapse_rate_e=lapse_rate_e)
