"""Closed-form physics equations (reference: ``src/clima_eqns.f90``).

Device-side functions take tensors of any shape and keep their dtype; the
quadrature and grid helpers run on the host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as const

__all__ = [
    "zenith_angles_and_weights",
    "weights_to_bins",
    "bins_to_weights",
    "planck_fcn",
    "heat_capacity_shomate",
    "heat_capacity_nasa9",
    "eddy_for_heat",
    "vertical_grid",
    "gravity",
    "press_and_den",
    "rayleigh_vardavas",
    "equilibrium_temperature",
    "skin_temperature",
    "k_term_heat_redistribution",
    "f_heat_redistribution",
]


def zenith_angles_and_weights(ngauss: int):
    """Gauss-Legendre zenith angles (degrees) and weights (clima_eqns.f90:26-41)."""
    x, w = np.polynomial.legendre.leggauss(ngauss)
    # match the reference ordering (futils gauss_legendre returns ascending x)
    mu = x / 2.0 + 0.5
    zenith_angles = np.arccos(mu) * 180.0 / np.pi
    weights = w / 2.0
    return zenith_angles, weights


def weights_to_bins(weights):
    """Cumulative bin edges from weights (clima_eqns.f90:43-54). Host numpy."""
    weights = np.asarray(weights)
    zero = np.zeros_like(weights[..., :1])
    return np.concatenate([zero, np.cumsum(weights, axis=-1)], axis=-1)


def bins_to_weights(bins):
    return np.diff(np.asarray(bins), axis=-1)


def planck_fcn(nu, T):
    """Planck function, mW sr^-1 m^-2 Hz^-1 (clima_eqns.f90:64-73).

    Factored as 2e3 * (h*nu/c) * (nu/c) * nu / expm1(h*nu/(kb*T)) so that no
    intermediate (notably nu**3 ~ 1e43) overflows float32.
    """
    h = const.plank
    c = const.c_light
    kb = const.k_boltz_si
    x = (h * nu) / (kb * T)
    return 2.0e3 * (h * nu / c) * (nu / c) * nu / torch.expm1(x)


def heat_capacity_shomate(coeffs, T):
    """Shomate heat capacity, J/(mol K) (clima_eqns.f90:82-92). coeffs (..., 7)."""
    TT = T / 1000.0
    return (
        coeffs[..., 0]
        + coeffs[..., 1] * TT
        + coeffs[..., 2] * TT**2
        + coeffs[..., 3] * TT**3
        + coeffs[..., 4] / TT**2
    )


def heat_capacity_nasa9(coeffs, T):
    """NASA-9 heat capacity, J/(mol K) (clima_eqns.f90:94-103). coeffs (..., 9)."""
    R = const.Rgas_si
    return R * (
        coeffs[..., 0] / T**2
        + coeffs[..., 1] / T
        + coeffs[..., 2]
        + coeffs[..., 3] * T
        + coeffs[..., 4] * T**2
        + coeffs[..., 5] * T**3
        + coeffs[..., 6] * T**4
    )


def _smoother(x, a1, a2, beta):
    y = (1.0 / (a2 - a1)) * (x - a1)
    return 1.0 / (1.0 + (y / (1.0 - y)) ** (-beta))


def eddy_for_heat(l, g, T, dTdz, adiabat):
    """Mixing-length eddy diffusivity for heat (clima_eqns.f90:135-169).

    The three regimes (unstable / smoothed transition / stable) are selected
    elementwise with ``torch.where``.
    """
    eta = 0.1 * torch.abs(adiabat)
    arg = -(g / T) * (dTdz + adiabat)
    kh_full = l**2 * torch.sqrt(torch.clamp(arg, min=0.0))
    a1 = -adiabat - eta
    a2 = -adiabat
    in_transition = (a1 < dTdz) & (dTdz < a2)
    stable = dTdz >= a2
    # guard smoother args to the open interval to avoid nan where unused
    x = torch.minimum(torch.maximum(dTdz, a1 + 1e-300), a2 - 1e-300)
    smooth = _smoother(x, a1, a2, -2.0)
    zero = torch.zeros((), dtype=kh_full.dtype, device=kh_full.device)
    return torch.where(stable, zero, torch.where(in_transition, kh_full * smooth, kh_full))


def vertical_grid(bottom, top, nz):
    """Uniform vertical grid (clima_eqns.f90:172-184). Returns (z, dz)."""
    dz = (top - bottom) / nz * np.ones(nz)
    z = bottom + dz * (np.arange(nz) + 0.5)
    return z, dz


def gravity(radius, mass, z):
    """Gravity (cm/s^2) at altitude z (cm); radius cm, mass g (clima_eqns.f90:201-211)."""
    grav = const.G_grav * (mass / 1.0e3) / ((radius + z) / 1.0e2) ** 2
    return grav * 1.0e2


def press_and_den(T, grav, Psurf, dz, mubar):
    """Hydrostatic pressure and number density on a fixed-z grid.

    Mirrors clima_eqns.f90:213-238. Inputs (..., nz) tensors, layer axis
    last. Returns (pressure dynes/cm^2, density molecules/cm^3).
    """
    kb = const.k_boltz
    Na = const.N_avo
    T_mid = torch.cat([T[..., :1], 0.5 * (T[..., 1:] + T[..., :-1])], dim=-1)
    factors = torch.exp(
        -((mubar * grav) / (Na * kb * T_mid))
        * torch.cat([0.5 * dz[..., :1], dz[..., 1:]], dim=-1)
    )
    pressure = Psurf * torch.cumprod(factors, dim=-1)
    density = pressure / (kb * T)
    return pressure, density


def rayleigh_vardavas(A, B, Delta, lam_nm):
    """Vardavas Rayleigh cross-section, cm^2 (clima_eqns.f90:240-246). lam in nm."""
    lam_um = lam_nm * 1.0e-3
    return (
        4.577e-21
        * ((6.0 + 3.0 * Delta) / (6.0 - 7.0 * Delta))
        * (A * (1.0 + B / lam_um**2)) ** 2
        * (1.0 / lam_um**4)
    )


def equilibrium_temperature(stellar_radiation, bond_albedo):
    return ((stellar_radiation * (1.0 - bond_albedo)) / (4.0 * const.sigma_si)) ** 0.25


def skin_temperature(stellar_radiation, bond_albedo):
    return equilibrium_temperature(stellar_radiation, bond_albedo) * 0.5**0.25


def k_term_heat_redistribution(L, grav, chi, mubar, cp, n_LW, Cd):
    """k term of Koll (2022) Eq. 10 (clima_eqns.f90:264-283)."""
    sigma_cgs = const.sigma_si * 1.0e3
    R_bar = const.Rgas / mubar
    Beta = R_bar / (cp * n_LW)
    return (
        (L * grav)
        / (chi * Beta * cp)
        * ((Cd * sigma_cgs**2) / R_bar) ** (1.0 / 3.0)
        * (1.0e6) ** (-2.0 / 3.0)
        * (600.0) ** (4.0 / 3.0)
    )


def f_heat_redistribution(tau_LW, Ps, Teq, k):
    """Heat redistribution parameter f, Koll (2022) Eq. 10 (clima_eqns.f90:286-298)."""
    t = tau_LW ** (1.0 / 3.0) * (Ps / 1.0e6) ** (2.0 / 3.0) * (Teq / 600.0) ** (-4.0 / 3.0)
    return 2.0 / 3.0 - (5.0 / 12.0) * t / (k + t)
