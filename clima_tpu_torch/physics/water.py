"""Hard-coded H2O latent heat and saturation vapor pressure fits.

Reference: ``src/clima_eqns_water.f90`` (exp-fit latent heats, SVP via the
Clausius-Clapeyron integral using the exponential-integral function Ei).
Functions take tensors (or Python floats, as float64) and keep their dtype
and device.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "latent_heat_H2O",
    "latent_heat_H2O_vap",
    "latent_heat_H2O_sub",
    "sat_pressure_H2O",
    "sat_pressure_H2O_vap",
    "sat_pressure_H2O_sub",
    "T_freeze",
    "mu_H2O",
    "Rgas",
]

Rgas = 8.31446261815324e7  # erg/(mol*K)
mu_H2O = 18.01534  # g/mol

A_v = -3413485157036.1396
B_v = 4.093669788667096e-06
C_v = 3441894705040.859

A_s = -208246976589.85126
B_s = -2.0162205697439128e-05
C_s = 235714178130.73007

T0 = 373.15  # K
P0 = 1.0142e6  # dynes/cm2
T_freeze = 273.15  # K

# constants precomputed in the reference (clima_eqns_water.f90:76,87-88)
_I_v_T0 = -20369368.110596914
_I_v_Tfreeze = 3141290.0653794562
_I_s_Tfreeze = 124184300.01342696

_EULER_GAMMA = 0.5772156649015329
# 1 / (k * k!) for k = 16 down to 1: the power series of Ei past its log term
_EXPI_COEFFS = [1.0 / (k * math.factorial(k)) for k in range(16, 0, -1)]


def _tensor(T):
    return T if torch.is_tensor(T) else torch.as_tensor(T, dtype=torch.float64)


def expi(x):
    """The exponential integral Ei(x) = gamma + ln|x| + sum_k x^k / (k k!).

    The series in Horner form, 16 terms: to double precision for |x| <= 0.5.
    The fits above call it at B*T with |B| <= 2.1e-5, so |x| < 0.05 at any
    temperature below 2400 K (torch has no Ei).
    """
    x = _tensor(x)
    s = torch.zeros_like(x)
    for c in _EXPI_COEFFS:
        s = (s + c) * x
    return _EULER_GAMMA + torch.log(torch.abs(x)) + s


def latent_heat_H2O_vap(T):
    """Latent heat of vaporization, erg/g."""
    return A_v * torch.exp(B_v * _tensor(T)) + C_v


def latent_heat_H2O_sub(T):
    """Latent heat of sublimation, erg/g."""
    return A_s * torch.exp(B_s * _tensor(T)) + C_s


def latent_heat_H2O(T):
    T = _tensor(T)
    return torch.where(T > T_freeze, latent_heat_H2O_vap(T), latent_heat_H2O_sub(T))


def _integral_fcn(A, B, C, T):
    """The integral of L/T^2 dT (clima_eqns_water.f90:63-68)."""
    return (-A * B * T * expi(B * T) + A * torch.exp(B * T) + C) / T


def sat_pressure_H2O_vap(T):
    """SVP over liquid water, dynes/cm^2."""
    tmp = _integral_fcn(A_v, B_v, C_v, _tensor(T)) - _I_v_T0
    return P0 * torch.exp((mu_H2O / Rgas) * (-tmp))


def sat_pressure_H2O_sub(T):
    """SVP over ice, dynes/cm^2."""
    tmp = (_I_v_Tfreeze - _I_v_T0) + (_integral_fcn(A_s, B_s, C_s, _tensor(T)) - _I_s_Tfreeze)
    return P0 * torch.exp((mu_H2O / Rgas) * (-tmp))


def sat_pressure_H2O(T):
    T = _tensor(T)
    return torch.where(T > T_freeze, sat_pressure_H2O_vap(T), sat_pressure_H2O_sub(T))
