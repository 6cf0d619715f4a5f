"""LinearLatentHeat condensation model, vectorized over gases.

Reference: ``src/clima_saturationdata.f90``. A species' latent heat is linear
in T in three regimes (sublimation below the triple point, vaporization up to
the critical point, a non-physical super-critical continuation above) and the
SVP follows from the analytic Clausius-Clapeyron integral
``P_ref * exp((mu/Rgas) * (-A/T + B lnT - ...))`` (:93-167).

The parameters are stacked over ALL gases; non-condensible gases get
``has_sat=False`` and an SVP of BIG, so the dry/condensing classification
runs unmasked and vectorized.

Temperatures are per column: ``T`` of shape (...) gives results of shape
(..., ng). The regime a value is evaluated in is chosen by ``T_branch``
(default T itself); :func:`select_branch` picks the regime's constants once,
so a caller that evaluates many temperatures in one regime (an RK4 piece of
the profile march) selects them once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as const

__all__ = ["SaturationParams", "sat_pressure", "latent_heat", "sat_pressure_derivative",
           "select_branch", "sat_pressure_branch", "BIG"]

BIG = 1.0e30  # stand-in for huge(1.0_dp): SVP of non-condensibles (finite in f32)

_FIELDS = ("mu", "T_ref", "P_ref", "T_triple", "T_critical",
           "a_v", "b_v", "a_s", "b_s", "a_c", "b_c")
_DEFAULTS = dict(mu=1.0, T_ref=300.0, P_ref=1.0e6, T_triple=100.0, T_critical=600.0,
                 a_v=1.0e10, b_v=0.0, a_s=1.0e10, b_s=0.0, a_c=1.0e10, b_c=0.0)


@dataclasses.dataclass(frozen=True)
class SaturationParams:
    """Per-gas LinearLatentHeat parameters, arrays of shape (ng,): numpy on
    the host (:meth:`from_gas_list`) or tensors on a device (:meth:`to`).

    ``branch_table`` (tensors only): (ng*3, 5) constants of each regime
    (sublimation, vaporization, super-critical) for :func:`select_branch`,
    gas-major; ``branch_base`` (ng,) each gas's first row; ``mu_R``
    mu/Rgas and ``no_sat`` ~has_sat (ng,).
    """

    has_sat: object  # bool
    mu: object
    T_ref: object
    P_ref: object
    T_triple: object
    T_critical: object
    a_v: object
    b_v: object
    a_s: object
    b_s: object
    a_c: object
    b_c: object
    branch_table: object = None
    branch_base: object = None
    mu_R: object = None
    no_sat: object = None

    @classmethod
    def from_gas_list(cls, sats):
        """Build from a list of per-gas dicts (or None for non-condensibles)."""

        def arr(key):
            return np.array([s[key] if s is not None else _DEFAULTS[key] for s in sats],
                            dtype=np.float64)

        return cls(has_sat=np.array([s is not None for s in sats]),
                   **{k: arr(k) for k in _FIELDS})

    def to(self, device, dtype=torch.float64) -> "SaturationParams":
        """The same parameters as tensors on ``device``, with the regime table."""
        t = {k: torch.as_tensor(np.asarray(getattr(self, k)), dtype=dtype, device=device)
             for k in _FIELDS}
        has_sat = torch.as_tensor(np.asarray(self.has_sat), dtype=torch.bool, device=device)
        p = dataclasses.replace(self, has_sat=has_sat, **t)
        ng = has_sat.shape[0]
        return dataclasses.replace(
            p, branch_table=_branch_table(p).reshape(3 * ng, 5),
            branch_base=torch.arange(ng, device=device) * 3, mu_R=p.mu / const.Rgas,
            no_sat=~has_sat)


def _integral(A, B, T):
    """integral of L/T^2 dT with L = A + B*T (clima_saturationdata.f90:157-167)."""
    return -A / T + B * torch.log(T)


def _branch_table(p):
    """(ng, 3, 5): per regime [-a, b, K, D, a] with the SVP exponent
    ``tmp = (K + (-a/T + b lnT)) - D``, the reference's three integrals in
    its order of operations (:93-155); vaporization has K = 0."""
    I = _integral
    rows = [
        (p.a_s, p.b_s, I(p.a_v, p.b_v, p.T_triple) - I(p.a_v, p.b_v, p.T_ref),
         I(p.a_s, p.b_s, p.T_triple)),
        (p.a_v, p.b_v, torch.zeros_like(p.a_v), I(p.a_v, p.b_v, p.T_ref)),
        (p.a_c, p.b_c, I(p.a_v, p.b_v, p.T_critical) - I(p.a_v, p.b_v, p.T_ref),
         I(p.a_c, p.b_c, p.T_critical)),
    ]
    return torch.stack([torch.stack([-a, b, K, D, a], dim=-1) for a, b, K, D in rows], dim=1)


def select_branch(p: SaturationParams, Tb):
    """The regime constants at branch temperatures ``Tb`` (...): a tuple
    (-a, b, K, D, a), each (..., ng). The regime is super-critical where
    Tb >= T_critical, vaporization where Tb > T_triple, sublimation below
    (:80-91)."""
    Tx = Tb[..., None]
    regime = (Tx > p.T_triple).long() + (Tx >= p.T_critical).long()
    return p.branch_table[p.branch_base + regime].unbind(-1)


def sat_pressure_branch(p: SaturationParams, branch, T):
    """Saturation pressure (dynes/cm^2) at T (...) -> (..., ng) with the
    regime constants ``branch`` from :func:`select_branch`."""
    neg_a, b, K, D, _ = branch
    Tx = T[..., None]
    tmp = (K + (neg_a / Tx + b * torch.log(Tx))) - D
    return (p.P_ref * torch.exp(p.mu_R * tmp)).masked_fill(p.no_sat, BIG)


def latent_heat(p: SaturationParams, T, T_branch=None):
    """Latent heat erg/g across the three regimes (:80-91): T (...) -> (..., ng).

    ``T_branch`` (optional, shape of T) selects the regime instead of T
    itself: the profile integrator pins a whole RK substep piece to one
    branch so its stage evaluations never straddle the latent-heat JUMP at
    T_triple.
    """
    _, b, _, _, a = select_branch(p, T if T_branch is None else T_branch)
    return a + b * T[..., None]


def sat_pressure(p: SaturationParams, T, T_branch=None):
    """Saturation pressure (dynes/cm^2) of each gas at T (...) -> (..., ng).

    Non-condensible gases return BIG. ``T_branch`` pins the regime choice
    (see :func:`latent_heat`).
    """
    return sat_pressure_branch(p, select_branch(p, T if T_branch is None else T_branch), T)


def sat_pressure_derivative(p: SaturationParams, T):
    """dP_sat/dT (..., ng), in closed form.

    With P_sat = P_ref exp((mu/Rgas) tmp(T)) and tmp = (K + (-a/T + b lnT)) - D
    in the regime of T, dP_sat/dT = P_sat (mu/Rgas) (a/T^2 + b/T); zero for
    non-condensible gases (their SVP is the constant BIG). The JAX package
    takes the same derivative by forward-mode AD (``jax.jvp``), where the
    reference uses dual numbers (:170-184).
    """
    branch = select_branch(p, T)
    psat = sat_pressure_branch(p, branch, T)
    _, b, _, _, a = branch
    Tx = T[..., None]
    dtmp = a / Tx**2 + b / Tx
    return (psat * (p.mu_R * dtmp)).masked_fill(p.no_sat, 0.0)
