"""Radiative/convective profile reconstruction (``src/adiabat/clima_adiabat_rc.f90``),
batched over a leading column axis.

Port of the JAX package's ``clima_tpu/adiabat/profile_rc.py``, which builds
one column and is batched with ``vmap`` by the device RCE solver. Here every
function works on a batch of columns, as :mod:`.profile` does: temperatures
and pressures are (B,), per-gas quantities (B, ng), and each column has its
own convection mask. Given the mask ``convecting_with_below`` and
temperatures of the surface + radiative layers, rebuild the full column:
convective zones integrate T along the generalized moist adiabat; radiative
zones interpolate the prescribed temperatures and integrate only the
hydrostatic altitude. Handles dry<->condensing switching including cold
traps (condensing gas whose mixing ratio would increase with altitude
switches to dry, rc.f90:697-751) and custom prescribed-mix species
(CustomDrySpeciesType, rc.f90:786-833).

The march runs the 2*nz grid intervals with fixed RK4 substeps. Each
interval picks, per column, the convective or radiative right-hand side with
a data select, not a host branch, and locates in-substep events with
``argmin`` and gathers, so an interval has no host synchronisation. On a
CUDA device one interval is captured as a CUDA graph
(:func:`..ops.cuda_graph.graphed`) and replayed for the others. Everything
that changes between calls (the convection masks, the temperature nodes, the
surface state, RH and the custom-mix arrays) enters the interval as a graph
input, so a capture cached per shape (the ``graphs`` argument of
:func:`make_profile_rc_core`, keyed by the batch size among others) serves
every later mask and temperature profile, as the JAX package's one jit does.
On the CPU the march runs eagerly.

The radiative-region temperature interpolator is a carried node array
updated in place as convective temps are computed, which reproduces the
reference's re-initialized interpolator semantics (rc.f90:322-342) because
interpolation brackets only ever touch nodes already determined.
``super_saturated`` is always False, matching the reference (rc.f90:795).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import constants as const
from ..config.species import heat_capacity
from ..ops.cuda_graph import graphed
from ..ops.interp import searchsorted_right
from ..physics import saturation
from .profile import AdiabatParams, F_DRY_MIN, _linspace, kink_temps

__all__ = ["CustomMix", "make_profile_rc_core"]

EPS_ROOT = 1.0e-8  # thresholds in rc root functions (rc.f90:741,746)
LN10 = math.log(10.0)


@dataclasses.dataclass(frozen=True)
class CustomMix:
    """Prescribed custom mixing ratios: log10P ascending grid + log10 mix."""

    log10P: torch.Tensor  # (nPc,)
    log10mix: torch.Tensor  # (nPc, ng) — columns for non-custom species unused
    mask: torch.Tensor  # (ng,) bool


def _take(x, idx):
    """x (B, n[, ...]) at one index per column idx (B,) -> (B[, ...])."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _interp1(xs, ys, x):
    """Linear interpolation of ys(xs) at x and its slope: xs, ys (B, n), x (B,)."""
    idx = searchsorted_right(xs, x[:, None])[:, 0]
    xa, xb = _take(xs, idx), _take(xs, idx + 1)
    ya, yb = _take(ys, idx), _take(ys, idx + 1)
    t = (x - xa) / (xb - xa)
    return ya + t * (yb - ya), (yb - ya) / (xb - xa)


def _custom_f(cm: CustomMix, P):
    """Normalized custom mixing-ratio shares at pressures P (B,) (rc.f90:816-831), (B, ng)."""
    lg = torch.log10(P)
    idx = searchsorted_right(cm.log10P, lg)
    xa, xb = cm.log10P[idx], cm.log10P[idx + 1]
    ma, mb = cm.log10mix[idx], cm.log10mix[idx + 1]
    t = ((lg - xa) / (xb - xa))[:, None]
    lf = ma + t * (mb - ma)
    f = torch.where(cm.mask, 10.0**lf, 0.0)
    return f / torch.clamp(torch.sum(f, dim=-1, keepdim=True), min=1e-200)


def _mix_rc(RH_psat, cond, cm, f_i_dry, P):
    """Mixing ratios from RH * Psat (B, ng) at P (B,) (rc.f90:786-833): (f_i, f_dry)."""
    f_c = torch.clamp(RH_psat / P[:, None], max=1.0)
    f_moist = torch.sum(torch.where(cond, f_c, 0.0), dim=-1)
    f_dry = torch.clamp(1.0 - f_moist, min=F_DRY_MIN)
    plain_dry = (~cond) & (~cm.mask)
    f_dry_tot = torch.sum(torch.where(plain_dry, f_i_dry, 0.0), dim=-1)
    f_custom = _custom_f(cm, P) * ((1.0 - f_dry_tot) * f_dry)[:, None]
    f_i = torch.where(cond, f_c, torch.where(cm.mask, f_custom, f_dry[:, None] * f_i_dry))
    return f_i, f_dry


def mixing_ratios_rc(par, RH, cond, cm: CustomMix, f_i_dry, P, T, T_branch=None):
    """Mixing ratios with condensing/dry/custom species (rc.f90:786-833).

    ``T_branch`` pins the latent-heat regime: the event-split RK4 pieces
    must be analytic within a piece.
    """
    return _mix_rc(RH * saturation.sat_pressure(par.sat, T, T_branch), cond, cm, f_i_dry, P)


def update_f_i_dry_rc(cond, cm: CustomMix, f_i, P):
    """Repartition dry fractions after a switch (rc.f90:767-784)."""
    P_i = f_i * P[:, None]
    dry_or_custom = (~cond) | cm.mask  # custom never condenses
    P_dry = torch.sum(torch.where(dry_or_custom & (~cond), P_i, 0.0), dim=-1, keepdim=True)
    return P_i / torch.clamp(P_dry, min=1e-200)


def _lapse_rc(par, cond, f_i_dry, f_i, f_dry, T, T_branch):
    """Generalized adiabat dlnT/dlnP with custom species in cp_dry
    (rc.f90:835-891), from the mixing ratios (f_i, f_dry) at (P, T)."""
    cp_i = heat_capacity(par.thermo, T)
    cp_dry = torch.sum(torch.where(~cond, f_i_dry * cp_i, 0.0), dim=-1) + 1e-300
    L = saturation.latent_heat(par.sat, T, T_branch) * par.gas_masses * 1.0e-7
    Rsi = const.Rgas_si
    beta = L / (Rsi * T[:, None])
    first = torch.sum(torch.where(cond, f_i * (cp_i - Rsi * beta + Rsi * beta**2), 0.0), dim=-1)
    second = torch.sum(torch.where(cond, beta * f_i, 0.0), dim=-1)
    return 1.0 / (f_dry * ((cp_dry * f_dry + first) / (Rsi * (f_dry + second))) + second)


def _root_switches(par, RH, cond, cm, f_i_dry, P, T, dTdlog10P, in_conv):
    """Apply dry<->condensing switches from the rc root functions.

    dry -> condensing when P_i/Psat > 1+eps (rc.f90:743-747).
    condensing -> dry (cold trap) when dlog10(f_i)/dP < eps, evaluated only
    in radiative regions (rc.f90:709-741): the mixing ratio of a condensing
    species, f = Psat(T(P))/P, would increase with altitude.
    Returns the updated (cond, f_i_dry).
    """
    psat = RH * saturation.sat_pressure(par.sat, T)
    f_i, _ = _mix_rc(psat, cond, cm, f_i_dry, P)
    Px = P[:, None]
    P_i = f_i * Px

    to_cond = (~cond) & (~cm.mask) & par.sat.has_sat & (P_i / psat > 1.0 + EPS_ROOT)

    dPi_dT = RH * saturation.sat_pressure_derivative(par.sat, T)
    dTdP = (dTdlog10P / (P * LN10))[:, None]
    dPi_dP = dPi_dT * dTdP
    dfi_dP = (1.0 / Px) * dPi_dP - psat / Px**2
    dlog10fi_dP = dfi_dP / (torch.clamp(f_i, min=1e-200) * LN10)
    to_dry = cond & (~in_conv[:, None]) & (dlog10fi_dP < EPS_ROOT)

    new_cond = (cond | to_cond) & (~to_dry)
    switched = torch.any(new_cond != cond, dim=-1, keepdim=True)
    f_i_dry = torch.where(switched, update_f_i_dry_rc(new_cond, cm, f_i, P), f_i_dry)
    return new_cond, f_i_dry


def _gravity(par, z):
    return (const.G_grav * (par.planet_mass / 1.0e3)
            / ((par.planet_radius + z) / 1.0e2) ** 2 * 1.0e2)


def _rc_interval(par, kinks, kvalid, gas, RH, cm_log10P, cm_log10mix, cm_mask, node_logP_asc,
                 P_a, P_b, conv_flag, node_i, z, T_run, cond, fid, T_nodes):
    """The K substeps of one grid interval [P_a, P_b] (B,) of every column,
    convective where ``conv_flag`` (B,): returns the new carry (z, T, cond,
    fid, T_nodes) and the mixing ratios and lapse rate at P_b."""
    cm = CustomMix(cm_log10P, cm_log10mix, cm_mask)
    K = par.substeps
    la, lb = torch.log(P_a), torch.log(P_b)
    T_nodes_desc = torch.flip(T_nodes, dims=[1])
    convx = conv_flag[:, None]

    def T_interp(P):
        return _interp1(node_logP_asc, T_nodes_desc, torch.log10(P))  # slope dT/dlog10P

    def rhs(P, zz, TT, cond, fid, Tb):
        # cond/fid are passed explicitly: each RK substep integrates with the
        # state updated at the previous substep boundary. ``Tb`` pins the
        # latent-heat branch of a convective RK4 piece.
        grav = _gravity(par, zz)
        f_i, f_dry = mixing_ratios_rc(par, RH, cond, cm, fid, P, TT, Tb)
        dz_c = -(const.Rgas * TT) / (grav * P * torch.sum(f_i * par.gas_masses, dim=-1))
        dT_c = _lapse_rc(par, cond, fid, f_i, f_dry, TT, Tb) * TT / P
        T_r, _ = T_interp(P)
        f_r, _ = mixing_ratios_rc(par, RH, cond, cm, fid, P, T_r)
        dz_r = -(const.Rgas * T_r) / (grav * P * torch.sum(f_r * par.gas_masses, dim=-1))
        return torch.where(conv_flag, dz_c, dz_r), torch.where(conv_flag, dT_c, 0.0)

    def rk4p(Pa, Pb, z, T, cond, fid, Tb):
        h = Pb - Pa
        k1z, k1T = rhs(Pa, z, T, cond, fid, Tb)
        k2z, k2T = rhs(Pa + 0.5 * h, z + 0.5 * h * k1z, T + 0.5 * h * k1T, cond, fid, Tb)
        k3z, k3T = rhs(Pa + 0.5 * h, z + 0.5 * h * k2z, T + 0.5 * h * k2T, cond, fid, Tb)
        k4z, k4T = rhs(Pb, z + h * k3z, T + h * k3T, cond, fid, Tb)
        return (z + (h / 6.0) * (k1z + 2 * k2z + 2 * k3z + k4z),
                T + (h / 6.0) * (k1T + 2 * k2T + 2 * k3T + k4T))

    ng = gas.shape[0]
    for k in range(K):
        lp0 = la + (lb - la) * k / K
        lp1 = la + (lb - la) * (k + 1) / K
        p0, p1 = torch.exp(lp0), torch.exp(lp1)

        # piece 1: branch-pinned full substep
        T0 = T_run
        z1, T1 = rk4p(p0, p1, z, T_run, cond, fid, T0)

        if par.n_condensible:
            # convective in-substep events (the reference's dense-output
            # dop853 roots, rc.f90:434-536, and the latent-heat kinks its
            # adaptive stepping resolves), as in profile._rk4_event_split
            def g_sat(P, T):
                psat = RH * saturation.sat_pressure(par.sat, T, T0)
                f_i, _ = _mix_rc(psat, cond, cm, fid, P)
                return f_i * P[:, None] - psat

            dK0 = T0[:, None] - kinks
            crossed_k = convx & kvalid & (dK0 * (T1[:, None] - kinks) < 0.0)
            denomT = torch.where(torch.abs(T0 - T1) > 1e-300, T0 - T1, 1e-300)
            theta_k = torch.where(crossed_k, dK0 / denomT[:, None], torch.inf)
            g0 = g_sat(p0, T0)
            g1 = g_sat(p1, T1)
            newly = (convx & par.sat.has_sat & (~cond) & (~cm.mask)
                     & (g0 < 0.0) & (g1 >= 0.0))
            denomG = torch.where(torch.abs(g0 - g1) > 1e-300, g0 - g1, 1e-300)
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

            def piece_to(theta):
                Pc = torch.exp(lp0 + theta * (lp1 - lp0))
                return (Pc, *rk4p(p0, Pc, z, T_run, cond, fid, T0))

            def residual_at(theta):
                Pc, _, Tc = piece_to(theta)
                return torch.where(is_kink, Tc - K_sel, _take(g_sat(Pc, Tc), j_gas))

            def refine(theta_a, r_a):
                denom = torch.where(torch.abs(r0 - r_a) > 1e-300, r0 - r_a, 1e-300)
                th = theta_a * r0 / denom
                return torch.clamp(torch.where(torch.isfinite(th), th, theta_a),
                                   1e-6, 1.0 - 1e-6)

            theta1 = refine(theta0, residual_at(theta0))
            theta2 = refine(theta1, residual_at(theta1))
            Pc, zc, Tc = piece_to(theta2)
            # onset: grow the condensing set + repartition the dry pool
            # (mixing ratios at the root under the OLD state, THEN the
            # switch, the reference's order, rc.f90:494-501)
            onset = (has_event & (~is_kink))[:, None]
            cond2 = cond | ((gas == j_gas[:, None]) & onset)
            f_c, _ = mixing_ratios_rc(par, RH, cond, cm, fid, Pc, Tc, T0)
            fid2 = torch.where(onset, update_f_i_dry_rc(cond2, cm, f_c, Pc), fid)
            # piece 2: far-side latent-heat branch / grown set
            z2, T2 = rk4p(Pc, p1, zc, Tc, cond2, fid2, T1)
            z_new = torch.where(has_event, z2, z1)
            T_u = torch.where(has_event, T2, T1)
            cond = torch.where(has_event[:, None], cond2, cond)
            fid = torch.where(has_event[:, None], fid2, fid)
        else:
            z_new, T_u = z1, T1

        T_interp_val, slope = T_interp(p1)
        T_new = torch.where(conv_flag, T_u, T_interp_val)
        # state switching at substep boundaries (radiative-side events:
        # saturation onsets against the prescribed T, cold traps)
        cond, fid = _root_switches(par, RH, cond, cm, fid, p1, T_new, slope, conv_flag)
        z, T_run = z_new, T_new

    # outputs at the grid point P_b
    f_i, f_dry = mixing_ratios_rc(par, RH, cond, cm, fid, P_b, T_run)
    lr = _lapse_rc(par, cond, fid, f_i, f_dry, T_run, None)

    # the temperature node of a convective layer's center takes the adiabat's T
    upd = (conv_flag & (node_i >= 0))[:, None]
    idx = torch.clamp(node_i, min=0).expand(T_nodes.shape[0], 1)
    T_nodes = torch.where(upd, T_nodes.scatter(1, idx, T_run[:, None]), T_nodes)
    return z, T_run, cond, fid, T_nodes, f_i, lr


def make_profile_rc_core(par: AdiabatParams, RH, T_surf, T_in, P_i_surf,
                         convecting_with_below, cm: CustomMix, graphs=None):
    """Rebuild a batch of columns, each for its own convection mask.

    RH (ng,) or (B, ng); P_i_surf (B, ng); T_surf (B,); T_in (B, nz)
    prescribed layer temperatures (values in convective layers are ignored
    and replaced by the adiabat integration); convecting_with_below (B, nz)
    bool. On a CUDA device the interval's graph is looked up in, or captured
    into, the dict ``graphs`` (a fresh capture per call when None), which
    then holds (replay, captured step) by shape, the batch size included: a
    graph replays on buffers of the batch it was captured at. Returns a dict
    of (B, ...) tensors with the edge arrays plus the updated layer
    temperatures ``T`` and ``lapse_rate_e``.
    """
    dtype, device = T_in.dtype, T_in.device
    B = T_surf.shape[0]
    nz = par.nz
    ne = 2 * nz + 1
    RH = RH.expand(B, -1)

    # ---- surface classification with custom species (rc.f90:218-264) ----
    psat_surf = RH * saturation.sat_pressure(par.sat, T_surf)
    cond0 = (~cm.mask) & par.sat.has_sat & (P_i_surf > psat_surf)
    P_i_cur = torch.where(cm.mask, 0.0, torch.where(cond0, psat_surf, P_i_surf))
    N_surface = torch.where(cond0, (P_i_surf - psat_surf) / (par.gas_masses * _gravity(par, 0.0)),
                            0.0)
    P_custom_tot = torch.sum(torch.where(cm.mask, P_i_surf, 0.0), dim=-1)
    P_surf = torch.sum(P_i_cur, dim=-1) + P_custom_tot
    P_i_cur = torch.where(cm.mask, P_custom_tot[:, None] * _custom_f(cm, P_surf), P_i_cur)
    f_i_dry0 = update_f_i_dry_rc(cond0, cm, P_i_cur / P_surf[:, None], P_surf)

    # ---- pressure grid, endpoints pinned ----
    P_top = torch.full_like(P_surf, par.P_top)
    P_e = 10.0 ** _linspace(torch.log10(P_surf), torch.log10(P_top), ne)
    P_e = torch.cat([P_surf[:, None], P_e[:, 1:-1], P_top[:, None]], dim=1)

    # ---- temperature nodes: [surface, layer centers] over ascending log10P ----
    T_nodes0 = torch.cat([T_surf[:, None], T_in], dim=1)
    node_logP_asc = torch.flip(torch.log10(torch.cat([P_surf[:, None], P_e[:, 1::2]], dim=1)),
                               dims=[1])

    # surface cold-trap pre-check (rc.f90:416-427): if the surface region is
    # radiative, demote condensing gases whose mixing ratio would increase
    conv0 = convecting_with_below[:, 0]
    _, slope0 = _interp1(node_logP_asc, torch.flip(T_nodes0, dims=[1]), torch.log10(P_surf))
    cond0_b, _ = _root_switches(par, RH, cond0, cm, f_i_dry0, P_surf, T_surf, slope0,
                                torch.zeros_like(conv0))
    # only the condensing->dry demotion applies here; only when radiative
    conv0x = conv0[:, None]
    cond_start = torch.where(conv0x, cond0, cond0 & cond0_b)
    f_i_surf, f_dry_surf = mixing_ratios_rc(par, RH, cond0, cm, f_i_dry0, P_surf, T_surf)
    fid_start = torch.where(conv0x, f_i_dry0,
                            update_f_i_dry_rc(cond_start, cm, f_i_surf, P_surf))

    # per-interval inputs: each column's governing-layer mask, and the
    # temperature node of each grid point that is a layer center (-1 elsewhere)
    m = np.arange(2 * nz)
    li = np.minimum((m + 1) // 2, nz - 1)
    node_out = np.where(m % 2 == 0, (m + 2) // 2, -1)
    conv_i = convecting_with_below[:, torch.as_tensor(li, device=device)]
    node_i = torch.as_tensor(node_out, device=device)

    kinks, kvalid = kink_temps(par.sat)
    gas = torch.arange(par.gas_masses.shape[0], device=device)
    step = functools.partial(_rc_interval, par, kinks, kvalid, gas)
    per_call = (RH, cm.log10P, cm.log10mix, cm.mask, node_logP_asc)
    xs = lambda i: (P_e[:, i], P_e[:, i + 1], conv_i[:, i], node_i[i])
    carry = (torch.zeros_like(T_surf), T_surf, cond_start, fid_start, T_nodes0)
    if device.type == "cuda":
        # one interval's graph, replayed for every interval; a replay
        # overwrites the previous one's outputs, so the levels keep copies.
        # The cache keeps the captured step too: the graph reads the tensors
        # it closes over (kinks, kvalid, gas) where they lay at capture.
        key = (B, par.substeps, nz, cm.log10P.shape[0], dtype)
        if graphs is not None and key in graphs:
            replay, _ = graphs[key]
            out = replay(*per_call, *xs(0), *carry)
        else:
            replay, out = graphed(step, *per_call, *xs(0), *carry)
            if graphs is not None:
                graphs[key] = (replay, step)
        keep = torch.clone
    else:
        replay, keep = step, (lambda t: t)
        out = step(*per_call, *xs(0), *carry)
    levels = [[keep(out[i])] for i in (1, 0, 5, 6)]  # T, z, f_i, lapse rate
    for i in range(1, ne - 1):
        out = replay(*per_call, *xs(i), *out[:5])
        for lev, j in zip(levels, (1, 0, 5, 6)):
            lev.append(keep(out[j]))
    T_lev, z_lev, f_lev, lr_lev = (torch.stack(lev, dim=1) for lev in levels)

    # The SURFACE record uses the state from surface classification, BEFORE
    # the radiative cold-trap pre-check: the reference stores lapse_rate(1)
    # and f_i(1,:) at integrate() entry (rc.f90:357-359) and only then runs
    # the pre-check (rc.f90:416-427).
    lr_surf = _lapse_rc(par, cond0, f_i_dry0, f_i_surf, f_dry_surf, T_surf, None)
    return dict(
        P_e=P_e,
        T_e=torch.cat([T_surf[:, None], T_lev], dim=1),
        z_e=torch.cat([torch.zeros_like(T_surf)[:, None], z_lev], dim=1),
        f_i_e=torch.cat([f_i_surf[:, None], f_lev], dim=1),
        lapse_rate_e=torch.cat([lr_surf[:, None], lr_lev], dim=1),
        T=keep(out[4])[:, 1:],
        N_surface=N_surface,
        P_surf=P_surf,
    )
