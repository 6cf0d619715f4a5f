"""Plain reference of the adiabat column model, in plain PyTorch.

A frozen copy of the port's plain paths for ``column_model``: the moist
multispecies pseudoadiabat of Graham et al. (2021) on the 2 nz + 1 log-P
grid (Clima's ``clima_adiabat_general.f90``: RK4 substeps split at
latent-heat kinks and condensation onsets, the tropopause crossing, the
isothermal stratosphere), the hydrostatic altitude solve
(``clima_adiabat_altitude.f90``), the doubled radiative grid
(``clima_adiabat.f90:729-773``) and the radiative-transfer chain of
:mod:`.radtran`. It runs eagerly, on any device, and skips on the host the
work whose result every column discards (the split of a substep in which no
column has an event, the tropopause step where no column crosses, the march
of columns all above their tropopause): the results are the same, and the
eager march costs a fraction of its full length. It reads the species
document itself and imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import radtran

__all__ = ["Model", "column_model"]

RGAS, RGAS_SI = 8.31446261815324e7, 8.31446261815324
K_BOLTZ, G_GRAV, N_AVO = 1.380649e-16, 6.67430e-11, 6.02214076e23
F_DRY_MIN, G_GRAV_CGS, BIG = 1.0e-40, 6.67e-8, 1.0e30


@dataclasses.dataclass
class Model:
    """The column model's constants on one device, in one dtype."""

    masses: torch.Tensor  # (ng,) g/mol
    temps: torch.Tensor  # (ng, ranges+1) heat-capacity range edges
    poly: torch.Tensor  # (ng*ranges, 7) cp in powers of T, J/(mol K)
    base: torch.Tensor  # (ng,)
    has_sat: torch.Tensor  # (ng,) bool
    T_triple: torch.Tensor
    T_critical: torch.Tensor
    P_ref: torch.Tensor
    mu_R: torch.Tensor
    branch_table: torch.Tensor  # (ng*3, 5)
    nz: int
    planet_mass: float
    planet_radius: float
    P_top: float
    T_trop: float
    substeps: int
    chain: radtran.Chain

    @classmethod
    def build(cls, species_doc, nz, planet_mass, planet_radius, chain, device, dtype,
              P_top=1.0, T_trop=180.0, substeps=6):
        """From the species document (atoms, species with Shomate thermo and
        LinearLatentHeat saturation)."""
        mass_of = {a["name"]: float(a["mass"]) for a in species_doc["atoms"]}
        gases = species_doc["species"]
        ng = len(gases)
        masses = np.array([sum(mass_of[a] * n for a, n in g["composition"].items())
                           for g in gases])
        n_ranges = max(len(g["thermo"]["data"]) for g in gases)
        temps = np.zeros((ng, n_ranges + 1))
        poly = np.zeros((ng, n_ranges, 7))
        for i, g in enumerate(gases):
            if g["thermo"]["model"] != "Shomate":
                raise ValueError(f"{g['name']}: only Shomate heat capacities are supported")
            tr, data = g["thermo"]["temperature-ranges"], g["thermo"]["data"]
            temps[i, :len(tr)] = tr
            temps[i, len(tr):] = tr[-1]
            for r in range(n_ranges):
                A, B, C, D, E = data[min(r, len(data) - 1)][:5]
                poly[i, r] = [E * 1.0e6, 0.0, A, B / 1.0e3, C / 1.0e6, D / 1.0e9, 0.0]
        defaults = dict(mu=1.0, T_ref=300.0, P_ref=1.0e6, T_triple=100.0, T_critical=600.0,
                        a_v=1.0e10, b_v=0.0, a_s=1.0e10, b_s=0.0, a_c=1.0e10, b_c=0.0)
        sat = []
        for g in gases:
            s = g.get("saturation")
            if s is None:
                sat.append(defaults)
                continue
            p = s["parameters"]
            sat.append(dict(mu=p["mu"], T_ref=p["T-ref"], P_ref=p["P-ref"],
                            T_triple=p["T-triple"], T_critical=p["T-critical"],
                            a_v=s["vaporization"]["a"], b_v=s["vaporization"]["b"],
                            a_s=s["sublimation"]["a"], b_s=s["sublimation"]["b"],
                            a_c=s["super-critical"]["a"], b_c=s["super-critical"]["b"]))
        t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)
        p = {k: t([s[k] for s in sat]) for k in defaults}
        I = lambda A, B, T: -A / T + B * torch.log(T)
        rows = [
            (p["a_s"], p["b_s"], I(p["a_v"], p["b_v"], p["T_triple"])
             - I(p["a_v"], p["b_v"], p["T_ref"]), I(p["a_s"], p["b_s"], p["T_triple"])),
            (p["a_v"], p["b_v"], torch.zeros_like(p["a_v"]), I(p["a_v"], p["b_v"], p["T_ref"])),
            (p["a_c"], p["b_c"], I(p["a_v"], p["b_v"], p["T_critical"])
             - I(p["a_v"], p["b_v"], p["T_ref"]), I(p["a_c"], p["b_c"], p["T_critical"])),
        ]
        table = torch.stack([torch.stack([-a, b, K, D, a], dim=-1) for a, b, K, D in rows], dim=1)
        return cls(masses=t(masses), temps=t(temps), poly=t(poly.reshape(-1, 7)),
                   base=torch.arange(ng, device=device) * n_ranges,
                   has_sat=torch.tensor([g.get("saturation") is not None for g in gases],
                                        device=device),
                   T_triple=p["T_triple"], T_critical=p["T_critical"], P_ref=p["P_ref"],
                   mu_R=p["mu"] / RGAS, branch_table=table.reshape(3 * ng, 5), nz=int(nz),
                   planet_mass=float(planet_mass), planet_radius=float(planet_radius),
                   P_top=float(P_top), T_trop=float(T_trop), substeps=int(substeps), chain=chain)


def _cp(m, T):
    Tx = T[..., None]
    n_ranges = m.temps.shape[1] - 1
    idx = torch.sum(Tx[..., None] >= m.temps[:, :-1], dim=-1) - 1
    flat = torch.clamp(idx, 0, n_ranges - 1) + m.base
    inv = 1.0 / Tx
    T2 = Tx * Tx
    powers = torch.cat([inv * inv, inv, torch.ones_like(Tx), Tx, T2, T2 * Tx, T2 * T2], dim=-1)
    cp = torch.sum(m.poly[flat] * powers[..., None, :], dim=-1)
    return cp.masked_fill(~((Tx >= m.temps[:, 0]) & (Tx < m.temps[:, -1])), torch.nan)


def _branch(m, Tb):
    Tx = Tb[..., None]
    regime = (Tx > m.T_triple).long() + (Tx >= m.T_critical).long()
    return m.branch_table[torch.arange(len(m.masses), device=Tb.device) * 3 + regime].unbind(-1)


def _psat_branch(m, branch, T):
    neg_a, b, K, D, _ = branch
    Tx = T[..., None]
    tmp = (K + (neg_a / Tx + b * torch.log(Tx))) - D
    return (m.P_ref * torch.exp(m.mu_R * tmp)).masked_fill(~m.has_sat, BIG)


def _psat(m, T):
    return _psat_branch(m, _branch(m, T), T)


def _norm_dry(mask, r_dry):
    r = r_dry.masked_fill(mask, 0.0)
    return r / torch.clamp(torch.sum(r, dim=-1, keepdim=True), min=1e-200)


def _mix(psat, P, mask, dry, rn):
    f_cond = torch.clamp(psat / P[..., None], max=1.0)
    f_dry = torch.clamp(1.0 - torch.sum(f_cond.masked_fill(dry, 0.0), dim=-1), min=F_DRY_MIN)
    return torch.where(mask, f_cond, f_dry[..., None] * rn), f_dry


def _update_mask(m, RH, mask, r_dry, P, T):
    psat = RH * _psat(m, T)
    for _ in range(int(m.has_sat.sum())):
        dry = ~mask
        f_i, _ = _mix(psat, P, mask, dry, _norm_dry(mask, r_dry))
        mask = mask | (dry & m.has_sat & (f_i * P[..., None] > psat))
    return mask


def _gravity(m, z):
    r = (m.planet_radius + z) / 1.0e2
    return G_GRAV * (m.planet_mass / 1.0e3) / (r * r) * 1.0e2


class _Piece:
    def __init__(self, m, mask, rn, Tb):
        self.mask, self.dry, self.rn, self.branch = mask, ~mask, rn, _branch(m, Tb)


def _rhs(m, RH, pc, P, T, z):
    psat = RH * _psat_branch(m, pc.branch, T)
    f_i, f_dry = _mix(psat, P, pc.mask, pc.dry, pc.rn)
    cp_i = _cp(m, T)
    cp_dry = torch.sum((pc.rn * cp_i).masked_fill(pc.mask, 0.0), dim=-1) + 1e-300
    _, b, _, _, a = pc.branch
    Tx = T[..., None]
    L = (a + b * Tx) * m.masses * 1.0e-7
    beta = L / (RGAS_SI * Tx)
    first = torch.sum((f_i * (cp_i - RGAS_SI * beta + RGAS_SI * (beta * beta)))
                      .masked_fill(pc.dry, 0.0), dim=-1)
    second = torch.sum((beta * f_i).masked_fill(pc.dry, 0.0), dim=-1)
    lapse = 1.0 / (f_dry * ((cp_dry * f_dry + first) / (RGAS_SI * (f_dry + second))) + second)
    mubar = torch.sum(f_i * m.masses, dim=-1)
    return lapse * (T / P), -(RGAS * T) / (_gravity(m, z) * P * mubar)


def _rk4(m, RH, pc, P0, P1, T, z):
    h = P1 - P0
    hh = 0.5 * h
    Pm = P0 + hh
    k1T, k1z = _rhs(m, RH, pc, P0, T, z)
    k2T, k2z = _rhs(m, RH, pc, Pm, T + hh * k1T, z + hh * k1z)
    k3T, k3z = _rhs(m, RH, pc, Pm, T + hh * k2T, z + hh * k2z)
    k4T, k4z = _rhs(m, RH, pc, P1, T + h * k3T, z + h * k3z)
    h6 = h / 6.0
    return (T + h6 * (k1T + 2 * k2T + 2 * k3T + k4T), z + h6 * (k1z + 2 * k2z + 2 * k3z + k4z))


def _take(x, idx):
    return torch.gather(x, -1, idx[:, None])[:, 0]


def _event_step(m, RH, mask, r_dry, rn, la, lb, T, z, kinks, kvalid):
    """One RK4 substep over log-P [la, lb], split at the first latent-heat
    kink or condensation onset of each column that meets one."""
    ng = m.masses.shape[0]
    Pa, Pb = torch.exp(la), torch.exp(lb)
    pc0 = _Piece(m, mask, rn, T)
    T1, z1 = _rk4(m, RH, pc0, Pa, Pb, T, z)

    def g_sat(P, Tv):
        psat = RH * _psat_branch(m, pc0.branch, Tv)
        f_i, _ = _mix(psat, P, mask, pc0.dry, rn)
        return f_i * P[..., None] - psat

    dK0 = T[:, None] - kinks
    crossed = kvalid & (dK0 * (T1[:, None] - kinks) < 0.0)
    dT = T - T1
    theta_k = torch.where(crossed, dK0 / torch.where(torch.abs(dT) > 1e-300, dT, 1e-300)[:, None],
                          torch.inf)
    g0, g1 = g_sat(Pa, T), g_sat(Pb, T1)
    newly = m.has_sat & pc0.dry & (g0 < 0.0) & (g1 >= 0.0)
    dg = g0 - g1
    theta_m = torch.where(newly, g0 / torch.where(torch.abs(dg) > 1e-300, dg, 1e-300), torch.inf)
    thetas = torch.cat([theta_k, theta_m], dim=-1)
    j = torch.argmin(thetas, dim=-1)
    th_j = _take(thetas, j)
    has_event = torch.isfinite(th_j) & (th_j < 1.0)
    if not bool(has_event.any()):
        return T1, z1
    theta0 = torch.clamp(torch.where(has_event, th_j, 0.5), 1e-6, 1.0 - 1e-6)
    is_kink = j < 2 * ng
    K_sel = torch.where(is_kink, kinks[torch.clamp(j, max=2 * ng - 1)], 0.0)
    j_gas = torch.where(is_kink, 0, j - 2 * ng)
    r0 = torch.where(is_kink, T - K_sel, _take(g0, j_gas))
    dl = lb - la

    def residual(theta):
        Pc = torch.exp(la + theta * dl)
        Tc, _ = _rk4(m, RH, pc0, Pa, Pc, T, z)
        return torch.where(is_kink, Tc - K_sel, _take(g_sat(Pc, Tc), j_gas))

    def refine(theta_a, r_a):
        dr = r0 - r_a
        th = theta_a * r0 / torch.where(torch.abs(dr) > 1e-300, dr, 1e-300)
        return torch.clamp(torch.where(torch.isfinite(th), th, theta_a), 1e-6, 1.0 - 1e-6)

    theta1 = refine(theta0, residual(theta0))
    theta2 = refine(theta1, residual(theta1))
    Pc = torch.exp(la + theta2 * dl)
    Tc, zc = _rk4(m, RH, pc0, Pa, Pc, T, z)
    gas = torch.arange(ng, device=T.device)
    mask2 = mask | ((gas == j_gas[:, None]) & ~is_kink[:, None])
    T2, z2 = _rk4(m, RH, _Piece(m, mask2, _norm_dry(mask2, r_dry), T1), Pc, Pb, Tc, zc)
    return torch.where(has_event, T2, T1), torch.where(has_event, z2, z1)


def _z_isothermal(m, P, T, mubar, P0, z0):
    return ((N_AVO * K_BOLTZ * T) / (G_GRAV_CGS * m.planet_mass * mubar) * torch.log(P / P0)
            + 1.0 / (m.planet_radius + z0)) ** (-1.0) - m.planet_radius


def _substep(m, RH, r_dry, kinks, kvalid, T_trop, la, lb, T, z, mask, tropped, P_trop, z_trop,
             mu_trop):
    Pb = torch.exp(lb)
    rn = _norm_dry(mask, r_dry)
    if bool(tropped.all()):
        z_iso = _z_isothermal(m, Pb, T_trop, mu_trop, P_trop, z_trop)
        return T_trop.clone(), z_iso, mask, tropped, P_trop, z_trop, mu_trop

    def step(lb_):
        return _event_step(m, RH, mask, r_dry, rn, la, lb_, T, z, kinks, kvalid)

    T_new, z_new = step(lb)
    crossed = (~tropped) & (T_new <= T_trop)
    if bool(crossed.any()):
        theta = torch.where(crossed, (T - T_trop) / torch.clamp(T - T_new, min=1e-30), 1.0)
        lP_cross = la + theta * (lb - la)
        P_cross = torch.exp(lP_cross)
        _, z_cross = step(lP_cross)
        f_cross, _ = _mix(RH * _psat(m, T_trop), P_cross, mask, ~mask, rn)
        P_trop = torch.where(crossed, P_cross, P_trop)
        z_trop = torch.where(crossed, z_cross, z_trop)
        mu_trop = torch.where(crossed, torch.sum(f_cross * m.masses, dim=-1), mu_trop)
    tropped = tropped | crossed
    T_out = torch.where(tropped, T_trop, T_new)
    z_out = torch.where(tropped, _z_isothermal(m, Pb, T_trop, mu_trop, P_trop, z_trop), z_new)
    mask_new = _update_mask(m, RH, mask, r_dry, Pb, T_out)
    return (T_out, z_out, torch.where(tropped[:, None], mask, mask_new), tropped, P_trop, z_trop,
            mu_trop)


def _mixing_ratios(m, RH, mask, r_dry, P, T):
    return _mix(RH * _psat(m, T), P, mask, ~mask, _norm_dry(mask, r_dry))


def make_profile(m, RH, T_surf, P_i_surf):
    """The pseudoadiabats of a batch of columns on the 2 nz + 1 edge grid:
    dict of P_e, T_e, z_e (B, 2nz+1), f_i_e (B, 2nz+1, ng), P_surf,
    N_surface (B, ng)."""
    dtype, device = T_surf.dtype, T_surf.device
    B, ne = T_surf.shape[0], 2 * m.nz + 1
    T_trop = torch.full_like(T_surf, m.T_trop)
    psat = RH * _psat(m, T_surf)
    cond = m.has_sat & (P_i_surf > psat)
    P_i_atm = torch.where(cond, psat, P_i_surf)
    N_surface = torch.where(cond, (P_i_surf - psat) / (m.masses * _gravity(m, 0.0)), 0.0)
    dry = torch.where(cond, 0.0, P_i_atm)
    r_dry = dry / torch.clamp(torch.sum(dry, dim=-1, keepdim=True), min=1e-200)
    mask = cond
    P_surf = torch.sum(P_i_atm, dim=-1)

    a, b = torch.log10(P_surf), torch.log10(torch.full_like(P_surf, m.P_top))
    s = torch.arange(ne - 1, dtype=dtype, device=device) / (ne - 1)
    lin = torch.cat([a[:, None] * (1 - s) + b[:, None] * s, b[:, None]], dim=-1)
    P_e = torch.cat([P_surf[:, None], (10.0 ** lin)[:, 1:-1],
                     torch.full_like(P_surf, m.P_top)[:, None]], dim=-1)
    f_surf, _ = _mixing_ratios(m, RH, mask, r_dry, P_surf, T_surf)
    kinks = torch.cat([m.T_triple, m.T_critical])
    kvalid = torch.cat([m.has_sat, m.has_sat])
    K = m.substeps
    lP = torch.log(P_e)
    k = torch.arange(K, dtype=dtype, device=device)
    la_all = lP[:, :-1, None] + (lP[:, 1:] - lP[:, :-1])[:, :, None] * k / K
    lb_all = lP[:, :-1, None] + (lP[:, 1:] - lP[:, :-1])[:, :, None] * (k + 1) / K

    state = (T_surf, torch.zeros_like(T_surf), mask, torch.zeros_like(mask[:, 0]),
             torch.full_like(T_surf, -1.0), torch.zeros_like(T_surf),
             torch.sum(f_surf * m.masses, dim=-1))
    T_lev, z_lev, f_lev = [T_surf], [torch.zeros_like(T_surf)], [f_surf]
    for i in range(ne - 1):
        for j in range(K):
            state = _substep(m, RH, r_dry, kinks, kvalid, T_trop, la_all[:, i, j],
                             lb_all[:, i, j], *state)
        T, z, mask, tropped, P_trop = state[:5]
        f_i, _ = _mixing_ratios(m, RH, mask, r_dry, torch.where(tropped, P_trop, P_e[:, i + 1]),
                                torch.where(tropped, T_trop, T))
        T_lev.append(T)
        z_lev.append(z)
        f_lev.append(f_i)
    return dict(P_e=P_e, T_e=torch.stack(T_lev, dim=-1), z_e=torch.stack(z_lev, dim=-1),
                f_i_e=torch.stack(f_lev, dim=1), P_surf=P_surf, N_surface=N_surface)


def _interp_at(xs, x):
    idx = torch.clamp(torch.searchsorted(xs, x[:, None], right=True) - 1, 0, xs.shape[-1] - 2)
    x0 = torch.gather(xs, -1, idx)[:, 0]
    return idx, (x - x0) / (torch.gather(xs, -1, idx + 1)[:, 0] - x0)


def _lerp(ys, idx, t):
    y0 = torch.gather(ys, -1, idx)[:, 0]
    return y0 + t * (torch.gather(ys, -1, idx + 1)[:, 0] - y0)


def altitude_dz(m, P, T, mubar, P_surf, T_surf, mubar_surf, substeps=4):
    """Layer thicknesses dz (B, nz) of the hydrostatic altitude solve on the
    edge grid, anchored at the surface."""
    B, nz = P.shape
    ne = 2 * nz + 1
    P_e = torch.empty((B, ne), dtype=P.dtype, device=P.device)
    P_e[:, 0] = P_surf
    P_e[:, 1::2] = P
    P_e[:, 2:-1:2] = torch.sqrt(P[:, :-1] * P[:, 1:])
    P_e[:, -1] = m.P_top
    lgrid = torch.log10(torch.cat([torch.flip(P, dims=[1]), P_surf[:, None]], dim=1))
    Tg = torch.cat([torch.flip(T, dims=[1]), T_surf[:, None]], dim=1)
    mg = torch.cat([torch.flip(mubar, dims=[1]), mubar_surf[:, None]], dim=1)
    GM = G_GRAV * (m.planet_mass / 1.0e3)

    def rhs(Pv, zv):
        idx, t = _interp_at(lgrid, torch.log10(Pv))
        grav = GM / ((m.planet_radius + zv) / 1.0e2) ** 2 * 1.0e2
        return -(RGAS * _lerp(Tg, idx, t)) / (grav * Pv * _lerp(mg, idx, t))

    z = torch.zeros_like(P_surf)
    zs = [z]
    for i in range(ne - 2):
        la, lb = torch.log(P_e[:, i]), torch.log(P_e[:, i + 1])
        for k in range(substeps):
            p0 = torch.exp(la + (lb - la) * k / substeps)
            p1 = torch.exp(la + (lb - la) * (k + 1) / substeps)
            h = p1 - p0
            k1 = rhs(p0, z)
            k2 = rhs(p0 + 0.5 * h, z + 0.5 * h * k1)
            k3 = rhs(p0 + 0.5 * h, z + 0.5 * h * k2)
            k4 = rhs(p1, z + h * k3)
            z = z + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        zs.append(z)
    zs.append(zs[ne - 2] + (zs[ne - 2] - zs[ne - 3]))
    z_e = torch.stack(zs, dim=1)
    return z_e[:, 2::2] - z_e[:, 0:-1:2]


def column_model(m, T_surf, P_i_surf, RH=None):
    """ISR, OLR, P_surf (B,) and N_atmos (B, ng) mol/cm^2 of columns T_surf
    (B,) K and P_i_surf (B, ng) dyn/cm^2, on their device; the radiative
    transfer runs on the device of ``m.chain``."""
    RH = torch.ones_like(m.masses) if RH is None else RH
    prof = make_profile(m, RH, T_surf, P_i_surf)
    P_c, T_c, f_c = prof["P_e"][:, 1::2], prof["T_e"][:, 1::2], prof["f_i_e"][:, 1::2]
    dz = altitude_dz(m, P_c, T_c, torch.sum(f_c * m.masses, dim=-1), prof["P_surf"], T_surf,
                     torch.sum(prof["f_i_e"][:, 0] * m.masses, dim=-1))
    dens = f_c * (P_c / (K_BOLTZ * T_c))[..., None]
    N_atmos = torch.sum(dens * dz[..., None], dim=1) / N_AVO

    def ghost(a):
        return torch.cat([torch.repeat_interleave(a, 2, dim=1), a[:, -1:], a[:, -1:]], dim=1)

    to = lambda x: x.to(m.chain.device)  # the chain may run on another device than the march
    fup_ir, fdn_ir, fup_sol, fdn_sol = radtran.fluxes(
        m.chain, to(T_surf), to(ghost(P_c) / 1.0e6), to(ghost(T_c)), to(ghost(dens)),
        to(ghost(0.5 * dz)))
    return dict(ISR=(fdn_sol[:, -1] - fup_sol[:, -1]).to(T_surf.device),
                OLR=(-(fdn_ir[:, -1] - fup_ir[:, -1])).to(T_surf.device),
                P_surf=prof["P_surf"], N_atmos=N_atmos)
