"""Moist multispecies pseudoadiabat construction (Graham et al. 2021 Eq. 1),
batched over a leading column axis.

Re-implements ``make_profile`` (``src/adiabat/clima_adiabat_general.f90``) as
the JAX package's ``clima_tpu/adiabat/profile.py`` does: the condensing set
is a pointwise fixed point of

    C = { i : f_dry(C) * r_i * P >= RH_i * Psat_i(T) }

with r_i the surface dry proportions, the profile integrates level by level
on the fixed 2*nz+1 log-P grid with fixed RK4 substeps split at events
(latent-heat kinks, condensation onsets), the tropopause crossing is located
inside its substep, and the stratosphere follows the reference's analytic
isothermal hydrostatic solution (general.f90:658-669).

Every function works on a batch of columns: temperatures, pressures and
altitudes are (B,), per-gas quantities (B, ng). The march has no host
synchronisation: events are picked with ``argmin`` and ``gather``, the
condensing-set update is a fixed-count loop. On a CUDA device the whole
march is one kernel launch (:mod:`..ops.march_cuda`); on the CPU it runs
eagerly through the kernel's twin :func:`_march_torch`, which on a card
captures the first interval as a CUDA graph and replays it for the others
(:func:`..ops.cuda_graph.graphed`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from ..config.species import GasThermo, heat_capacity
from ..ops.cuda_graph import graphed
from ..ops.march_cuda import count_events, moist_adiabat_march_cuda, pack_tables
from ..physics import saturation
from ..utils.profiling import span

__all__ = ["AdiabatParams", "make_profile_core", "mixing_ratios", "update_mask",
           "lapse_rate_moist", "kink_temps", "surface_classification"]

F_DRY_MIN = 1.0e-40  # general.f90:566
G_GRAV_CGS = 6.67e-8  # used by the reference's analytic altitude (general.f90:664)


@dataclasses.dataclass(frozen=True)
class AdiabatParams:
    """Static parameters of the profile constructors, tables on one device."""

    gas_masses: torch.Tensor  # (ng,)
    thermo: GasThermo  # tensor tables (GasThermo.to)
    sat: saturation.SaturationParams  # tensor tables (SaturationParams.to)
    nz: int
    planet_mass: float
    planet_radius: float
    P_top: float
    substeps: int = 4
    n_condensible: int = -1  # gases with a saturation model; counted when -1

    def __post_init__(self):
        if self.n_condensible < 0:
            object.__setattr__(self, "n_condensible", int(self.sat.has_sat.sum().item()))

    @functools.cached_property
    def march_tables(self):
        """The march kernel's per-gas table and constants
        (:func:`..ops.march_cuda.pack_tables`), packed on first use."""
        return pack_tables(self)

    @classmethod
    def from_species(cls, sp, nz, planet_mass, planet_radius, P_top, substeps, device,
                     dtype=torch.float64):
        """Parameters for a :class:`..config.species.Species` on ``device``."""
        return cls(
            gas_masses=torch.as_tensor(np.asarray(sp.gas_masses), dtype=dtype, device=device),
            thermo=sp.thermo.to(device, dtype),
            sat=saturation.SaturationParams.from_gas_list(sp.sat).to(device, dtype),
            nz=int(nz), planet_mass=float(planet_mass), planet_radius=float(planet_radius),
            P_top=float(P_top), substeps=int(substeps),
        )


class _Piece(NamedTuple):
    """What is fixed over one RK4 piece: the condensing set (and its
    complement), the normalized dry proportions under it and the saturation
    regime constants."""

    mask: torch.Tensor
    dry: torch.Tensor
    rn: torch.Tensor
    branch: tuple


def _norm_dry(mask, r_dry):
    r = r_dry.masked_fill(mask, 0.0)
    return r / torch.clamp(torch.sum(r, dim=-1, keepdim=True), min=1e-200)


def _mix(psat, P, mask, dry, rn):
    """Mixing ratios from psat = RH * Psat (B, ng) at P (B,), under the
    condensing set ``mask`` (``dry`` its complement): (f_i, f_dry)."""
    f_cond = torch.clamp(psat / P[..., None], max=1.0)
    f_moist = torch.sum(f_cond.masked_fill(dry, 0.0), dim=-1)
    f_dry = torch.clamp(1.0 - f_moist, min=F_DRY_MIN)
    f_i = torch.where(mask, f_cond, f_dry[..., None] * rn)
    return f_i, f_dry


def mixing_ratios(par: AdiabatParams, RH, mask, r_dry, P, T, T_branch=None):
    """Mixing ratios given the condensing mask (general.f90:548-574).

    mask: (B, ng) bool condensing set; r_dry: (B, ng) dry proportions
    (normalized over non-condensing gases); P, T (B,). Returns (f_i, f_dry).
    """
    psat = RH * saturation.sat_pressure(par.sat, T, T_branch)
    return _mix(psat, P, mask, ~mask, _norm_dry(mask, r_dry))


def update_mask(par: AdiabatParams, RH, mask, r_dry, P, T):
    """Pointwise fixed point of the condensing set (replaces event detection).

    Gases are added when their dry-extrapolated partial pressure exceeds
    saturation (the root ``P_sat - P_i`` of general.f90:483-513). The set only
    grows, and only condensible gases join it, so n_condensible passes reach
    the fixed point that the JAX package's ng passes reach.
    """
    psat = RH * saturation.sat_pressure(par.sat, T)
    for _ in range(par.n_condensible):
        dry = ~mask
        f_i, _ = _mix(psat, P, mask, dry, _norm_dry(mask, r_dry))
        mask = mask | (dry & par.sat.has_sat & (f_i * P[..., None] > psat))
    return mask


def _lapse(par, piece, T, f_i, f_dry):
    """dlnT/dlnP of Graham et al. (2021) Eq. 1 from the mixing ratios."""
    mask, dry = piece.mask, piece.dry
    cp_i = heat_capacity(par.thermo, T)  # J/(mol K)
    cp_dry = torch.sum((piece.rn * cp_i).masked_fill(mask, 0.0), dim=-1) + 1e-300
    _, b, _, _, a = piece.branch
    Tx = T[..., None]
    L = (a + b * Tx) * par.gas_masses * 1.0e-7  # J/mol
    Rsi = const.Rgas_si
    beta = L / (Rsi * Tx)
    first = torch.sum((f_i * (cp_i - Rsi * beta + Rsi * (beta * beta))).masked_fill(dry, 0.0),
                      dim=-1)
    second = torch.sum((beta * f_i).masked_fill(dry, 0.0), dim=-1)
    return 1.0 / (f_dry * ((cp_dry * f_dry + first) / (Rsi * (f_dry + second))) + second)


def _piece(par, mask, rn, Tb):
    return _Piece(mask, ~mask, rn, saturation.select_branch(par.sat, Tb))


def lapse_rate_moist(par: AdiabatParams, RH, mask, r_dry, P, T, T_branch=None):
    """Graham et al. (2021) Eq. 1 generalized moist lapse rate dlnT/dlnP, (B,).

    Mirrors general.f90:576-656 (no-condensate simplification).
    """
    piece = _piece(par, mask, _norm_dry(mask, r_dry), T if T_branch is None else T_branch)
    psat = RH * saturation.sat_pressure_branch(par.sat, piece.branch, T)
    f_i, f_dry = _mix(psat, P, mask, piece.dry, piece.rn)
    return _lapse(par, piece, T, f_i, f_dry)


def _gravity(par: AdiabatParams, z):
    r = (par.planet_radius + z) / 1.0e2
    return const.G_grav * (par.planet_mass / 1.0e3) / (r * r) * 1.0e2


def _mubar(par: AdiabatParams, f_i):
    return torch.sum(f_i * par.gas_masses, dim=-1)


def _rhs(par, RH, piece, P, T, z):
    """RHS of [dT/dP, dz/dP] (general.f90:576-656)."""
    psat = RH * saturation.sat_pressure_branch(par.sat, piece.branch, T)
    f_i, f_dry = _mix(psat, P, piece.mask, piece.dry, piece.rn)
    dT_dP = _lapse(par, piece, T, f_i, f_dry) * (T / P)
    dz_dP = -(const.Rgas * T) / (_gravity(par, z) * P * _mubar(par, f_i))
    return dT_dP, dz_dP


def _rk4(par, RH, piece, P0, P1, T, z):
    h = P1 - P0
    hh = 0.5 * h
    Pm = P0 + hh
    k1T, k1z = _rhs(par, RH, piece, P0, T, z)
    k2T, k2z = _rhs(par, RH, piece, Pm, T + hh * k1T, z + hh * k1z)
    k3T, k3z = _rhs(par, RH, piece, Pm, T + hh * k2T, z + hh * k2z)
    k4T, k4z = _rhs(par, RH, piece, P1, T + h * k3T, z + h * k3z)
    h6 = h / 6.0
    return (T + h6 * (k1T + 2 * k2T + 2 * k3T + k4T),
            z + h6 * (k1z + 2 * k2z + 2 * k3z + k4z))


def kink_temps(sat):
    """Temperatures where the RHS is only C0: latent-heat branch switches.

    LinearLatentHeat changes slope at T_triple (sublimation->vaporization)
    and T_critical (->super-critical constant), clima_saturationdata.f90:80-91.
    Integrating a fixed RK4 substep across one of these kinks degrades the
    order to ~1; the profile march splits substeps at the crossing instead.
    Returns (kinks, valid), each (2*ng,).
    """
    return (torch.cat([sat.T_triple, sat.T_critical]),
            torch.cat([sat.has_sat, sat.has_sat]))


def _take(x, idx):
    """x (B, n) at one index per column idx (B,) -> (B,)."""
    return torch.gather(x, -1, idx[:, None])[:, 0]


def _rk4_event_split(par, RH, mask, r_dry, rn, la, lb, T, z, kinks, kvalid):
    """One RK4 substep over log-P [la, lb], split at the first event crossing.

    Events (the reference's dense-output dop853 roots, general.f90:355-513):
    latent-heat regime kinks at T_triple / T_critical, where every RK4 piece
    pins the regime to its own side (``T_branch``), and dry->condensing
    switches, roots of ``f_i*P - RH_i*psat_i(T)`` of a still-dry species.
    The first event's location is refined with two secant iterations on the
    branch-pinned trajectory, and the step restarts on the other side (other
    latent-heat branch / grown condensing set). Columns without an event keep
    the unsplit step. Returns (T, z, split): split (B,) bool where the step
    was split.
    """
    ng = par.gas_masses.shape[0]
    Pa, Pb = torch.exp(la), torch.exp(lb)
    T0 = T
    piece0 = _piece(par, mask, rn, T0)
    T1u, z1u = _rk4(par, RH, piece0, Pa, Pb, T, z)
    T1 = T1u

    def g_sat(P, Tv):
        """Per-gas saturation excess f_i*P - RH_i*psat_i under the OLD mask."""
        psat = RH * saturation.sat_pressure_branch(par.sat, piece0.branch, Tv)
        f_i, _ = _mix(psat, P, mask, piece0.dry, rn)
        return f_i * P[..., None] - psat

    # candidate events with linear-in-theta first estimates
    dK0 = T0[:, None] - kinks
    crossed_k = kvalid & (dK0 * (T1[:, None] - kinks) < 0.0)
    dT = T0 - T1
    denomT = torch.where(torch.abs(dT) > 1e-300, dT, 1e-300)
    theta_k = torch.where(crossed_k, dK0 / denomT[:, None], torch.inf)
    g0 = g_sat(Pa, T0)
    g1 = g_sat(Pb, T1)
    newly = par.sat.has_sat & piece0.dry & (g0 < 0.0) & (g1 >= 0.0)
    dg = g0 - g1
    denomG = torch.where(torch.abs(dg) > 1e-300, dg, 1e-300)
    theta_m = torch.where(newly, g0 / denomG, torch.inf)

    thetas = torch.cat([theta_k, theta_m], dim=-1)
    j = torch.argmin(thetas, dim=-1)
    th_j = _take(thetas, j)
    has_event = torch.isfinite(th_j) & (th_j < 1.0)
    theta0 = torch.clamp(torch.where(has_event, th_j, 0.5), 1e-6, 1.0 - 1e-6)
    is_kink = j < 2 * ng
    K_sel = torch.where(is_kink, kinks[torch.clamp(j, max=2 * ng - 1)], 0.0)
    j_gas = torch.where(is_kink, 0, j - 2 * ng)
    r0 = torch.where(is_kink, T0 - K_sel, _take(g0, j_gas))
    dl = lb - la

    def residual_at(theta):
        Pc = torch.exp(la + theta * dl)
        Tc, _ = _rk4(par, RH, piece0, Pa, Pc, T, z)
        return torch.where(is_kink, Tc - K_sel, _take(g_sat(Pc, Tc), j_gas))

    def refine(theta_a, r_a):
        dr = r0 - r_a
        denom = torch.where(torch.abs(dr) > 1e-300, dr, 1e-300)
        th = theta_a * r0 / denom
        return torch.clamp(torch.where(torch.isfinite(th), th, theta_a), 1e-6, 1.0 - 1e-6)

    theta1 = refine(theta0, residual_at(theta0))
    theta2 = refine(theta1, residual_at(theta1))
    Pc = torch.exp(la + theta2 * dl)
    Tc, zc = _rk4(par, RH, piece0, Pa, Pc, T, z)
    # second piece: far-side L branch; condensing set grown on a mask event
    gas = torch.arange(ng, device=T.device)
    mask2 = mask | ((gas == j_gas[:, None]) & ~is_kink[:, None])
    piece2 = _piece(par, mask2, _norm_dry(mask2, r_dry), T1)
    T2, z2 = _rk4(par, RH, piece2, Pc, Pb, Tc, zc)
    return torch.where(has_event, T2, T1u), torch.where(has_event, z2, z1u), has_event


def _altitude_isothermal(par: AdiabatParams, P, T, mubar, P0, z0):
    """Analytic hydrostatic altitude for constant T, mubar (general.f90:658-669)."""
    return (
        (const.N_avo * const.k_boltz * T) / (G_GRAV_CGS * par.planet_mass * mubar)
        * torch.log(P / P0)
        + 1.0 / (par.planet_radius + z0)
    ) ** (-1.0) - par.planet_radius


def surface_classification(par: AdiabatParams, RH, T_surf, P_i_surf):
    """Surface dry/condensing split and reservoirs (general.f90:199-224).

    T_surf (B,), P_i_surf (B, ng). Returns (P_i_atm, N_surface, mask0, r_dry).
    """
    psat = RH * saturation.sat_pressure(par.sat, T_surf)
    cond = par.sat.has_sat & (P_i_surf > psat)
    P_i_atm = torch.where(cond, psat, P_i_surf)
    grav = _gravity(par, 0.0)
    N_surface = torch.where(cond, (P_i_surf - psat) / (par.gas_masses * grav), 0.0)
    dry = torch.where(cond, 0.0, P_i_atm)
    P_dry = torch.sum(dry, dim=-1, keepdim=True)
    r_dry = dry / torch.clamp(P_dry, min=1e-200)
    return P_i_atm, N_surface, cond, r_dry


def _substep(par, RH, r_dry, kinks, kvalid, T_trop, la, lb, T, z, mask, tropped, P_trop,
             z_trop, mubar_trop, splits):
    """One substep of the march over log-P [la, lb], all columns at once:
    the RK4 step, the tropopause crossing inside it, the isothermal
    stratosphere and the condensing-set growth. Returns the new state;
    ``splits`` (B,) counts the substeps below the tropopause whose step to
    lb was split at an event, as the kernel counts them."""
    rn = _norm_dry(mask, r_dry)
    if par.n_condensible:
        def step(lb_):
            return _rk4_event_split(par, RH, mask, r_dry, rn, la, lb_, T, z, kinks, kvalid)
    else:
        # no saturation regimes: the branch constants are never read, no step splits
        def step(lb_):
            return (*_rk4(par, RH, _piece(par, mask, rn, T), torch.exp(la), torch.exp(lb_), T, z),
                    torch.zeros_like(tropped))

    Pb = torch.exp(lb)
    T_new, z_new, split = step(lb)
    splits = splits + (split & ~tropped).to(splits.dtype)

    # tropopause crossing inside this substep (root T - T_trop)
    crossed = (~tropped) & (T_new <= T_trop)
    theta = torch.where(crossed, (T - T_trop) / torch.clamp(T - T_new, min=1e-30), 1.0)
    lP_cross = la + theta * (lb - la)
    P_cross = torch.exp(lP_cross)
    _, z_cross, _ = step(lP_cross)
    psat_trop = RH * saturation.sat_pressure(par.sat, T_trop)
    f_cross, _ = _mix(psat_trop, P_cross, mask, ~mask, rn)
    mubar_cross = _mubar(par, f_cross)

    P_trop = torch.where(crossed, P_cross, P_trop)
    z_trop = torch.where(crossed, z_cross, z_trop)
    mubar_trop = torch.where(crossed, mubar_cross, mubar_trop)
    tropped_new = tropped | crossed

    # above the tropopause: T = T_trop, analytic isothermal altitude
    T_out = torch.where(tropped_new, T_trop, T_new)
    z_iso = _altitude_isothermal(par, Pb, T_trop, mubar_trop, P_trop, z_trop)
    z_out = torch.where(tropped_new, z_iso, z_new)

    # condensing-set growth (only below the tropopause)
    mask_new = update_mask(par, RH, mask, r_dry, Pb, T_out)
    mask_out = torch.where(tropped_new[:, None], mask, mask_new)
    return T_out, z_out, mask_out, tropped_new, P_trop, z_trop, mubar_trop, splits


def _interval(par, RH, r_dry, kinks, kvalid, T_trop, K, la, lb, P_end, T, z, mask, tropped,
              P_trop, z_trop, mubar_trop, splits):
    """The K substeps of one grid interval (la/lb (B, K) substep bounds,
    P_end (B,) its upper edge): the new state and the mixing ratios at the
    interval's end, (T, z, mask, tropped, P_trop, z_trop, mubar_trop,
    splits, f_i)."""
    state = (T, z, mask, tropped, P_trop, z_trop, mubar_trop, splits)
    for k in range(K):
        state = _substep(par, RH, r_dry, kinks, kvalid, T_trop, la[:, k], lb[:, k], *state)
    T, z, mask, tropped, P_trop = state[:5]
    f_i, _ = mixing_ratios(par, RH, mask, r_dry, torch.where(tropped, P_trop, P_end),
                           torch.where(tropped, T_trop, T))
    return (*state, f_i)


def _linspace(start, stop, num):
    """jnp.linspace(start, stop, num) for start/stop (B,) -> (B, num): the
    two-sided form start*(1-s) + stop*s with s = i/(num-1), then stop."""
    div = num - 1
    s = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start[:, None] * (1 - s) + stop[:, None] * s
    return torch.cat([out, stop[:, None]], dim=-1)


class _Start(NamedTuple):
    """What the march starts from (general.f90:199-259), (B, ...) tensors."""

    T_trop: torch.Tensor  # (B,)
    P_e: torch.Tensor  # (B, 2nz+1), surface first
    P_surf: torch.Tensor
    N_surface: torch.Tensor
    mask0: torch.Tensor  # the surface condensing set
    r_dry: torch.Tensor
    f_i_surf: torch.Tensor


def _start(par: AdiabatParams, RH, T_surf, P_i_surf, T_trop):
    """The surface split, the pressure grid and the surface mixing ratios."""
    dtype, device = T_surf.dtype, T_surf.device
    B = T_surf.shape[0]
    ne = 2 * par.nz + 1
    T_trop = torch.as_tensor(T_trop, dtype=dtype, device=device).expand(B)

    P_i_atm, N_surface, mask0, r_dry = surface_classification(par, RH, T_surf, P_i_surf)
    P_surf = torch.sum(P_i_atm, dim=-1)

    # log-spaced pressure grid, endpoints pinned (general.f90:256-259)
    P_top = torch.full_like(P_surf, par.P_top)
    P_e = 10.0 ** _linspace(torch.log10(P_surf), torch.log10(P_top), ne)
    P_e = torch.cat([P_surf[:, None], P_e[:, 1:-1], P_top[:, None]], dim=-1)

    f_i_surf, _ = mixing_ratios(par, RH, mask0, r_dry, P_surf, T_surf)
    return _Start(T_trop, P_e, P_surf, N_surface, mask0, r_dry, f_i_surf)


def _march_torch(par: AdiabatParams, RH, T_surf, s: _Start):
    """The march in PyTorch, the twin of the kernel
    (:func:`..ops.march_cuda.moist_adiabat_march_cuda`): on a card the first
    interval of the grid is captured as a CUDA graph (its eager warm-up the
    span ops.cuda_graph.warmup) and replayed for the others; on the CPU the
    march runs eagerly. Returns (T_e, z_e, f_i_e, P_trop, events) as the
    kernel does, and adds the events to its own counters while the program
    records (:func:`..ops.march_cuda.count_events`)."""
    dtype, device = T_surf.dtype, T_surf.device
    ne = s.P_e.shape[1]
    kinks, kvalid = kink_temps(par.sat)
    K = par.substeps
    # log-P substep bounds of every interval, (B, ne-1, K)
    lP = torch.log(s.P_e)
    la_i, dl_i = lP[:, :-1, None], (lP[:, 1:] - lP[:, :-1])[:, :, None]
    k = torch.arange(K, dtype=dtype, device=device)
    la_all = la_i + dl_i * k / K
    lb_all = la_i + dl_i * (k + 1) / K

    step = functools.partial(_interval, par, RH, s.r_dry, kinks, kvalid, s.T_trop, K)
    state = (T_surf, torch.zeros_like(T_surf), s.mask0, torch.zeros_like(s.mask0[:, 0]),
             torch.full_like(T_surf, -1.0), torch.zeros_like(T_surf), _mubar(par, s.f_i_surf),
             torch.zeros(T_surf.shape, dtype=torch.int32, device=device))
    args = lambda i: (la_all[:, i], lb_all[:, i], s.P_e[:, i + 1])
    # a replay overwrites the previous one's outputs, so the levels keep copies
    with span("adiabat.profile.capture"):
        if device.type == "cuda":
            replay, out = graphed(step, *args(0), *state)
            keep = torch.clone
        else:
            replay, out, keep = step, step(*args(0), *state), (lambda t: t)
    T_lev, z_lev, f_lev = [out[0]], [out[1]], [out[8]]
    for i in range(1, ne - 1):
        with span("adiabat.profile.replay"):
            out = replay(*args(i), *out[:8])
            T_lev.append(keep(out[0]))
            z_lev.append(keep(out[1]))
            f_lev.append(keep(out[8]))
    mask_final, tropped_final, P_trop, splits = out[2], out[3], out[4], out[7]
    events = torch.stack([splits, (mask_final & ~s.mask0).any(dim=-1).to(torch.int32)], dim=-1)
    count_events(_march_torch, events)
    return (torch.stack([T_surf, *T_lev], dim=-1),
            torch.stack([torch.zeros_like(T_surf), *z_lev], dim=-1),
            torch.stack([s.f_i_surf, *f_lev], dim=1),
            torch.where(tropped_final, P_trop, -1.0), events)


_march_torch.event_splits = _march_torch.onset_columns = 0


@span("adiabat.profile")
def make_profile_core(par: AdiabatParams, RH, T_surf, P_i_surf, T_trop):
    """Build the adiabat profiles of a batch of columns on the 2*nz+1 edge grid.

    RH (ng,) or (B, ng); T_surf (B,); P_i_surf (B, ng); T_trop a float or
    (B,). Returns a dict of (B, ...) tensors: P_e (B, 2nz+1) (surface first,
    decreasing), T_e, z_e, f_i_e (B, 2nz+1, ng), P_trop (B,) (negative where
    no tropopause), N_surface (B, ng), P_surf (B,), mask_surf, r_dry.
    CUDA tensors march in one kernel launch (the span adiabat.profile.march,
    the launch alone adiabat.profile.march.kernel), CPU tensors through the
    kernel's twin.
    """
    with span("adiabat.profile.setup"):
        s = _start(par, RH, T_surf, P_i_surf, T_trop)
    if T_surf.device.type == "cuda":
        with span("adiabat.profile.march"):
            T_e, z_e, f_i_e, P_trop, _ = moist_adiabat_march_cuda(
                par, RH, T_surf, s.T_trop, s.mask0, s.r_dry, s.P_e, s.f_i_surf)
    else:
        T_e, z_e, f_i_e, P_trop, _ = _march_torch(par, RH, T_surf, s)
    with span("adiabat.profile.assemble"):
        return dict(P_e=s.P_e, T_e=T_e, z_e=z_e, f_i_e=f_i_e, P_trop=P_trop,
                    N_surface=s.N_surface, P_surf=s.P_surf, mask_surf=s.mask0, r_dry=s.r_dry)
