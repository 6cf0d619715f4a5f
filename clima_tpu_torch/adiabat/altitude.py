"""Hydrostatic altitude solve on the doubled edge grid, batched over columns.

Re-implements ``AdiabatClimate_compute_altitude``
(``src/adiabat/clima_adiabat_altitude.f90:16-179``) as the JAX package's
``clima_tpu/adiabat/altitude.py`` does: z(P) by integrating
dz/dP = -Rgas T / (g(z) P mubar) with T(log10P) and mubar(log10P) linear
interpolators, on the 2*nz+1 edge grid (edges are geometric means of the
center pressures), with optional ``reference_pressure`` anchoring of the
planet radius; fixed RK4 substeps per interval. On a CUDA device the first
interval is captured as a CUDA graph and replayed for the others
(:func:`..ops.cuda_graph.graphed`).
"""

from __future__ import annotations

import functools

import torch

from .. import constants as const
from ..ops.cuda_graph import graphed
from ..ops.interp import searchsorted_right
from ..utils.profiling import span

__all__ = ["compute_altitude_core"]


def _interp_at(xs, x):
    """Interval index and weight of x (B,) in the ascending grids xs (B, n)."""
    idx = searchsorted_right(xs, x[:, None])
    x0 = torch.gather(xs, -1, idx)[:, 0]
    x1 = torch.gather(xs, -1, idx + 1)[:, 0]
    return idx, (x - x0) / (x1 - x0)


def _lerp(ys, idx, t):
    y0 = torch.gather(ys, -1, idx)[:, 0]
    y1 = torch.gather(ys, -1, idx + 1)[:, 0]
    return y0 + t * (y1 - y0)


def _interp1(xs, ys, x):
    idx, t = _interp_at(xs, x)
    return _lerp(ys, idx, t)


def _rk4_interval(logP_grid, T_grid, mu_grid, GM, planet_radius, z_offset, K, z, Pa, Pb):
    """z at Pb from z at Pa (B,), K RK4 substeps evenly spaced in log P."""

    def rhs(Pv, zv):
        idx, t = _interp_at(logP_grid, torch.log10(Pv))
        grav = GM / ((planet_radius + zv - z_offset) / 1.0e2) ** 2 * 1.0e2
        return -(const.Rgas * _lerp(T_grid, idx, t)) / (grav * Pv * _lerp(mu_grid, idx, t))

    la, lb = torch.log(Pa), torch.log(Pb)
    for k in range(K):
        p0 = torch.exp(la + (lb - la) * k / K)
        p1 = torch.exp(la + (lb - la) * (k + 1) / K)
        h = p1 - p0
        k1 = rhs(p0, z)
        k2 = rhs(p0 + 0.5 * h, z + 0.5 * h * k1)
        k3 = rhs(p0 + 0.5 * h, z + 0.5 * h * k2)
        k4 = rhs(p1, z + h * k3)
        z = z + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return (z,)


@span("adiabat.altitude")
def compute_altitude_core(P, T, mubar, P_surf, T_surf, mubar_surf, P_top,
                          planet_mass, planet_radius, reference_pressure=-1.0,
                          substeps=4):
    """Compute edge altitudes and per-layer z/dz/gravity for a batch of columns.

    P/T/mubar: (B, nz) layer centers (ground-up); P_surf/T_surf/mubar_surf
    (B,); P_top, planet_mass, planet_radius, reference_pressure floats.
    Returns dict with z (B, nz), dz (B, nz), gravity (B, nz), gravity_surf
    (B,), z_e (B, 2nz+1).
    """
    with span("adiabat.altitude.setup"):
        B, nz = P.shape
        ne = 2 * nz + 1

        # edge grid (altitude.f90:45-50)
        P_e = torch.empty((B, ne), dtype=P.dtype, device=P.device)
        P_e[:, 0] = P_surf
        P_e[:, 1::2] = P
        P_e[:, 2:-1:2] = torch.sqrt(P[:, :-1] * P[:, 1:])
        P_e[:, -1] = P_top

        # interpolators on ascending log10P (altitude.f90:57-87)
        logP_grid = torch.log10(torch.cat([torch.flip(P, dims=[1]), P_surf[:, None]], dim=1))
        T_grid = torch.cat([torch.flip(T, dims=[1]), T_surf[:, None]], dim=1)
        mu_grid = torch.cat([torch.flip(mubar, dims=[1]), mubar_surf[:, None]], dim=1)
        GM = const.G_grav * (planet_mass / 1.0e3)
        zero = torch.zeros_like(P_surf)

    def surface_anchored(z_offset):
        # integrate edges 1..ne-2 from the surface; extrapolate the last edge
        # (altitude.f90:180-193: the T interpolator does not cover P_top)
        step = functools.partial(_rk4_interval, logP_grid, T_grid, mu_grid, GM, planet_radius,
                                 z_offset, substeps)
        with span("adiabat.altitude.capture"):
            if P.device.type == "cuda":
                replay, (z,) = graphed(step, zero, P_e[:, 0], P_e[:, 1])
            else:
                replay, (z,) = step, step(zero, P_e[:, 0], P_e[:, 1])
        zs = [zero, z]
        for i in range(1, ne - 2):
            with span("adiabat.altitude.replay"):
                zs.append(replay(zs[-1], P_e[:, i], P_e[:, i + 1])[0].clone())
        with span("adiabat.altitude.assemble"):
            zs.append(zs[ne - 2] + (zs[ne - 2] - zs[ne - 3]))
            return torch.stack(zs, dim=1)

    if reference_pressure is not None and reference_pressure > 0:
        # Anchor the planet radius at reference_pressure (altitude.f90:97-169)
        # by two Picard iterations, as the JAX package does.
        with span("adiabat.altitude.setup"):
            Pref = torch.full_like(P_surf, reference_pressure)
            zref = zero
        for _ in range(2):
            z_e = surface_anchored(zref)
            with span("adiabat.altitude.assemble"):
                logPe_asc = torch.flip(torch.log10(P_e[:, : ne - 1]), dims=[1])
                zref = _interp1(logPe_asc, torch.flip(z_e[:, : ne - 1], dims=[1]),
                                torch.log10(Pref))
        z_ref_for_radius = zref
    else:
        z_e = surface_anchored(zero)
        z_ref_for_radius = zero

    with span("adiabat.altitude.assemble"):
        z = z_e[:, 1::2]
        dz = z_e[:, 2::2] - z_e[:, 0:-1:2]

        def grav_at(zv):
            return GM / ((planet_radius + zv - z_ref_for_radius[..., None]) / 1.0e2) ** 2 * 1.0e2

        gravity = grav_at(z)
        gravity_surf = grav_at(zero[:, None])[:, 0]
        return dict(z=z, dz=dz, gravity=gravity, gravity_surf=gravity_surf, z_e=z_e)
