"""Plain reference of the radiative-transfer chain, in plain PyTorch.

A frozen copy of the port's plain paths: the opacity assembly of
``compute_opacity`` (hat-basis k-table interpolation, the RORR mix by the
sort path, Rayleigh, CIA, photolysis, the water continuum and Mie particles),
the Toon et al. (1989) two-stream solves of both channels by 2x2-block
parallel cyclic reduction, the gauss- and zenith-weight reductions and the
frequency integration (Clima's ``clima_radtran_types.f90:574-888``,
``clima_radtran_twostream.f90`` and ``clima_radtran_radiate.f90``). No CUDA
kernel, no program code: it runs on any device, in any float dtype, from the
tables of :mod:`.optics`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .optics import stellar_flux, zenith_angles_and_weights

__all__ = ["Chain", "fluxes"]

PI = 3.14159265358979323846
PLANK, C_LIGHT, K_BOLTZ_SI = 6.62607004e-34, 299792458.0, 1.380649e-23
MAX_W0, MAX_GT, TAU_MIN = 0.99999, 0.999999, 1.0e-20
SQRT3 = 3.0**0.5
SORT_CHUNK_KEYS = 1 << 24


class Chain:
    """The chain's tables and surface settings on ``device`` in ``dtype``.

    ``tables``: :class:`.optics.OpticalTables`; ``star``: the stellar table;
    ``n_zenith``, ``albedo`` and ``photon_scale``: the settings' values.
    """

    def __init__(self, tables, star, n_zenith, albedo, device, dtype, photon_scale=1.0,
                 diurnal=0.5, emissivity=1.0, ir_tau_min=1.0e-6):
        t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                                      device=device)
        self.dtype, self.device = dtype, device
        self.k = [(j, t(lp), t(T), t(lk)) for j, lp, T, lk in tables.k]
        self.cia = [(j, jj, t(T), t(x)) for j, jj, T, x in tables.cia]
        self.ray = [(j, t(x)) for j, x in tables.ray]
        self.pxs = [(j, t(x)) for j, x in tables.pxs]
        self.part = [(p, t(r), t(w0), t(q), t(g)) for p, r, w0, q, g in tables.part]
        self.cont = None if tables.cont is None else (
            tables.cont[0], *(t(x) for x in tables.cont[1:]))
        self.wbin = t(tables.wbin)
        self.wbin_e = t(np.concatenate([[0.0], np.cumsum(tables.wbin)]))
        self.freq = t(tables.freq)
        self.nw = len(tables.wavl) - 1
        self.ir, self.sol = tables.ir, tables.sol
        wavl_sol = tables.wavl[self.sol[0]: self.sol[1] + 2]
        self.photons = t(stellar_flux(star, wavl_sol) * photon_scale)
        u, w = zenith_angles_and_weights(n_zenith)
        self.zen_u, self.zen_w = t(u), t(w)
        self.albedo = float(albedo)
        self.emissivity = float(emissivity)
        self.diurnal, self.ir_tau_min = float(diurnal), float(ir_tau_min)


def _hat(grid, x):
    xc = torch.clamp(x, grid[0], grid[-1])[..., None]
    gl = torch.cat([grid[:1] - 1.0, grid[:-1]])
    gr = torch.cat([grid[1:], grid[-1:] + 1.0])
    w = torch.clamp(torch.minimum((xc - gl) / (grid - gl), (gr - xc) / (gr - grid)), 0.0, 1.0)
    return w / torch.sum(w, dim=-1, keepdim=True)


def _log10(x):
    return torch.log10(torch.clamp(x, min=1e-300 if x.dtype == torch.float64 else 1e-37))


def _rorr_pair(mixed, nxt, wxy, wbin_e):
    nbin = mixed.shape[-1]
    tau_xy = (mixed[..., :, None] + nxt[..., None, :]).reshape(mixed.shape[:-1] + (nbin * nbin,))
    tau_sorted, order = torch.sort(tau_xy, dim=-1, stable=True)
    w_sorted = wxy[order]
    lower = torch.cumsum(w_sorted, dim=-1) - w_sorted
    F = torch.stack([torch.sum(tau_sorted * torch.minimum(torch.clamp(e - lower, min=0.0),
                                                          w_sorted), dim=-1)
                     for e in wbin_e], dim=-1)
    return torch.diff(F, dim=-1) / torch.diff(wbin_e)


def _rorr(tau_ks, wbin_e):
    """RORR mix of the species chain, (nk, ..., nbin) -> (..., nbin), by
    pairwise sums, a stable sort and the conservative rebin, over chunks of
    lanes."""
    nk, nbin = tau_ks.shape[0], tau_ks.shape[-1]
    wxy = (torch.diff(wbin_e)[:, None] * torch.diff(wbin_e)[None, :]).reshape(-1)
    lanes = tau_ks.reshape(nk, -1, nbin)
    chunk = max(1, SORT_CHUNK_KEYS // (nbin * nbin))
    out = []
    for i in range(0, lanes.shape[1], chunk):
        mixed = lanes[0, i:i + chunk]
        for s in range(1, nk):
            mixed = _rorr_pair(mixed, lanes[s, i:i + chunk], wxy, wbin_e)
        out.append(mixed)
    return torch.cat(out).reshape(tau_ks.shape[1:])


def opacity(c, P, T, dens, dz, pdens=None, radii=None):
    """(tau, w0) (B, W, G, nz) and g (B, W, nz), TOA-down, of ground-up
    columns: P (B, nz) bar, T (B, nz), dens (B, nz, ng) cm^-3, dz (B, nz) cm,
    pdens and radii (B, nz, np)."""
    flip = lambda x: None if x is None else torch.flip(x, dims=[1])
    P, T, dens, dz, pdens, radii = (flip(x) for x in (P, T, dens, dz, pdens, radii))
    B, nz = T.shape
    cols = dens * dz[..., None]
    log10P = torch.log10(P)
    tau_ks = []
    for j, lp, Tg, lk in c.k:
        G, nP, nT, W = lk.shape
        Wp, Wt = _hat(lp, log10P), _hat(Tg, T)
        WptT = (Wp.permute(2, 0, 1)[:, None] * Wt.permute(2, 0, 1)[None]).reshape(nP * nT, B * nz)
        tab = lk.permute(0, 3, 1, 2).reshape(G * W, nP * nT)
        k = 10.0 ** torch.matmul(tab, WptT).reshape(G, W, B, nz)
        tau_ks.append((k * cols[:, :, j]).permute(1, 2, 3, 0))  # (W, B, nz, G)
    tau_k = _rorr(torch.stack(tau_ks), c.wbin_e) if len(tau_ks) > 1 else tau_ks[0]

    zeros = torch.zeros((B, nz, c.nw), dtype=T.dtype, device=T.device)
    tausg = zeros
    for j, xs in c.ray:
        tausg = tausg + xs * cols[:, :, j, None]
    taua = zeros
    for j, jj, Tg, lxs in c.cia:
        lg = torch.matmul(_hat(Tg, T), lxs)
        lgcol = _log10(dens[:, :, j]) + _log10(dens[:, :, jj]) + torch.log10(dz)
        taua = taua + 10.0 ** (lg + lgcol[..., None])
    for j, xs in c.pxs:
        taua = taua + xs * cols[:, :, j, None]
    if c.cont is not None:
        L, Tg, lh, lf = c.cont
        Wt = _hat(Tg, T)
        foreign = torch.sum(cols, dim=-1) - cols[:, :, L]
        lgn = _log10(dens[:, :, L])
        taua = taua + 10.0 ** (torch.matmul(Wt, lh) + (lgn + _log10(cols[:, :, L]))[..., None])
        taua = taua + 10.0 ** (torch.matmul(Wt, lf) + (lgn + _log10(foreign))[..., None])
    tiny = 1e-300 if T.dtype == torch.float64 else 1e-37
    tauc = torch.full_like(zeros, tiny)
    tausc, g0c = tiny * tauc, tauc
    taup = tausp = gt_num = zeros
    if c.part and pdens is not None:
        for p, rg, w0t, qt, gtt in c.part:
            Wr = _hat(rg, radii[:, :, p])
            w0p, qp, gp = torch.matmul(Wr, w0t), torch.matmul(Wr, qt), torch.matmul(Wr, gtt)
            t1 = qp * PI * (radii[:, :, p] ** 2 * pdens[:, :, p] * dz)[..., None]
            taup, tausp = taup + t1, tausp + w0p * t1
            gt_num = gt_num + gp * (w0p * t1)

    scat = torch.clamp(tausp + tausg + tausc, min=TAU_MIN)
    g = torch.clamp(gt_num / scat + g0c * tausc / scat, max=MAX_GT)
    tau_cont = (tausg + taua + taup + tauc).transpose(1, 2)
    tausum = (tausg + tausp + tausc).transpose(1, 2)
    tau = tau_cont[:, :, None, :] + tau_k.permute(1, 0, 3, 2)
    w0 = torch.where(tau <= TAU_MIN, torch.zeros((), dtype=tau.dtype, device=tau.device),
                     torch.clamp(tausum[:, :, None, :] / tau, max=MAX_W0))
    return tau, w0, g.transpose(1, 2)


def _shift(x, k, fill):
    pad = torch.full(x.shape[:-1] + (abs(k),), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., k:], pad], dim=-1) if k > 0 else torch.cat([pad, x[..., :k]], dim=-1)


def _pcr(L01, M00, M01, M10, M11, U10, f0s, f1s):
    """2x2-block parallel cyclic reduction, one matrix and several right-hand
    sides (leading axis of f0s/f1s)."""
    m = M00.shape[-1]
    for s in range(max(1, math.ceil(math.log2(m)))):
        k = 1 << s
        inv = 1.0 / (M00 * M11 - M01 * M10)
        i00, i01, i10, i11 = M11 * inv, -M01 * inv, -M10 * inv, M00 * inv
        a0, a1 = L01 * _shift(i10, -k, 0.0), L01 * _shift(i11, -k, 1.0)
        g0, g1 = U10 * _shift(i00, +k, 1.0), U10 * _shift(i01, +k, 0.0)
        L01_new, U10_new = -a0 * _shift(L01, -k, 0.0), -g1 * _shift(U10, +k, 0.0)
        M00 = M00 - a1 * _shift(U10, -k, 0.0)
        M11 = M11 - g0 * _shift(L01, +k, 0.0)
        f0_new = f0s - a0 * _shift(f0s, -k, 0.0) - a1 * _shift(f1s, -k, 0.0)
        f1_new = f1s - g0 * _shift(f0s, +k, 0.0) - g1 * _shift(f1s, +k, 0.0)
        L01, U10, f0s, f1s = L01_new, U10_new, f0_new, f1_new
    inv = 1.0 / (M00 * M11 - M01 * M10)
    return (M11 * f0s - M01 * f1s) * inv, (M00 * f1s - M10 * f0s) * inv


def _es(lam, cap_gam, tau):
    wrk = torch.exp(-lam * tau)
    return 1.0 + cap_gam * wrk, 1.0 - cap_gam * wrk, cap_gam + wrk, cap_gam - wrk


def _matrix(e1, e2, e3, e4, Rsfc):
    z = torch.zeros_like(e1[..., :1])
    R = Rsfc[..., None]
    A_ev = torch.cat([z, e2[..., :-1] * e3[..., :-1] - e4[..., :-1] * e1[..., :-1]], -1)
    B_ev = torch.cat([e1[..., :1], e1[..., :-1] * e1[..., 1:] - e3[..., :-1] * e3[..., 1:]], -1)
    D_ev = torch.cat([-e2[..., :1], e3[..., :-1] * e4[..., 1:] - e1[..., :-1] * e2[..., 1:]], -1)
    A_od = torch.cat([e2[..., 1:] * e1[..., :-1] - e3[..., :-1] * e4[..., 1:],
                      e1[..., -1:] - R * e3[..., -1:]], -1)
    B_od = torch.cat([e2[..., :-1] * e2[..., 1:] - e4[..., :-1] * e4[..., 1:],
                      e2[..., -1:] - R * e4[..., -1:]], -1)
    D_od = torch.cat([e1[..., 1:] * e4[..., 1:] - e2[..., 1:] * e3[..., 1:], z], -1)
    return A_ev, B_ev, D_ev, A_od, B_od, D_od


def _rhs(e1, e2, e3, e4, cp0, cpb, cm0, cmb, Rsfc, Ssfc):
    R = Rsfc[..., None]
    E_ev = torch.cat([-cm0[..., :1], e3[..., :-1] * (cp0[..., 1:] - cpb[..., :-1])
                      + e1[..., :-1] * (cmb[..., :-1] - cm0[..., 1:])], -1)
    E_od = torch.cat([e2[..., 1:] * (cp0[..., 1:] - cpb[..., :-1])
                      - e4[..., 1:] * (cm0[..., 1:] - cmb[..., :-1]),
                      Ssfc - cpb[..., -1:] + R * cmb[..., -1:]], -1)
    return E_ev, E_od


def _solve(e1, e2, e3, e4, Rsfc, E_ev, E_od):
    A_ev, B_ev, D_ev, A_od, B_od, D_od = _matrix(e1, e2, e3, e4, Rsfc)
    batch = torch.broadcast_shapes(A_ev.shape, E_ev.shape[1:])
    ex = lambda x: x.expand(batch)
    return _pcr(ex(A_ev), ex(B_ev), ex(D_ev), ex(A_od), ex(B_od), ex(D_od),
                E_ev.expand((E_ev.shape[0],) + batch), E_od.expand((E_od.shape[0],) + batch))


def _cumsum(x):
    n, k = x.shape[-1], 1
    while k < n:
        x = x + torch.cat([torch.zeros_like(x[..., :k]), x[..., :-k]], dim=-1)
        k *= 2
    return x


def two_stream_solar(tau_in, w0_in, gt_in, u0s, Rsfc):
    """(fup, fdn) (nzen, rows, nz+1), TOA-down, TOA flux 1, for zenith
    cosines u0s (nzen,)."""
    u0 = u0s.reshape((-1,) + (1,) * tau_in.ndim)
    tau = tau_in * (1.0 - w0_in * gt_in * gt_in)
    w0 = w0_in * (1.0 - gt_in * gt_in) / (1.0 - w0_in * gt_in * gt_in)
    gt = gt_in / (1.0 + gt_in)
    gam1 = SQRT3 * (2.0 - w0 * (1.0 + gt)) / 2.0
    gam2 = SQRT3 * w0 * (1.0 - gt) / 2.0
    lam = torch.sqrt(gam1**2 - gam2**2)
    e1, e2, e3, e4 = _es(lam, gam2 / (gam1 + lam), tau)
    tauc = torch.cat([torch.zeros_like(tau[..., :1]), _cumsum(tau)], dim=-1)
    gam3 = (1.0 - SQRT3 * gt[None] * u0) / 2.0
    gam4 = 1.0 - gam3
    facp = w0[None] * ((gam1[None] - 1.0 / u0) * gam3 + gam4 * gam2[None])
    facm = w0[None] * ((gam1[None] + 1.0 / u0) * gam4 + gam2[None] * gam3)
    et0 = torch.exp(-tauc[None, ..., :-1] / u0)
    etb = et0 * torch.exp(-tau[None] / u0)
    denom = lam[None] ** 2 - 1.0 / u0**2
    direct = torch.cat([u0 * torch.ones_like(etb[..., :1]), u0 * etb], -1)
    cp0, cpb = et0 * facp / denom, etb * facp / denom
    cm0, cmb = et0 * facm / denom, etb * facm / denom
    Ssfc = Rsfc[None, ..., None] * direct[..., -1:]
    E_ev, E_od = _rhs(e1[None], e2[None], e3[None], e4[None], cp0, cpb, cm0, cmb, Rsfc, Ssfc)
    y1, y2 = _solve(e1, e2, e3, e4, Rsfc, E_ev, E_od)
    e1, e2, e3, e4 = e1[None], e2[None], e3[None], e4[None]
    top = y1[..., :1] * e3[..., :1] - y2[..., :1] * e4[..., :1] + cp0[..., :1]
    fup = torch.cat([top, y1 * e1 + y2 * e2 + cpb], -1)
    fdn = torch.cat([direct[..., :1], y1 * e3 + y2 * e4 + cmb + direct[..., 1:]], -1)
    return fup, fdn


def two_stream_ir(tau, w0, gt, emissivity, tau_min, bplanck):
    """(fup, fdn) (rows, nz+1), TOA-down, over a hard surface of
    ``emissivity`` (rows,); bplanck (rows, nz+1) at the edges, the ground last."""
    u1 = 0.5
    norm = 2.0 * PI * u1
    Rsfc = 1.0 - emissivity
    gam1 = 2.0 - w0 * (1.0 + gt)
    gam2 = w0 * (1.0 - gt)
    lam = torch.sqrt(gam1**2 - gam2**2)
    e1, e2, e3, e4 = _es(lam, gam2 / (gam1 + lam), tau)
    b_top, b_bot = bplanck[..., :-1], bplanck[..., 1:]
    thin = tau <= tau_min
    b0n = torch.where(thin, 0.5 * (b_top + b_bot), b_top)
    b1n = torch.where(thin, torch.zeros_like(tau),
                      (b_bot - b_top) / torch.where(thin, torch.ones_like(tau), tau))
    inv_g = 1.0 / (gam1 + gam2)
    cp0, cpb = norm * (b0n + b1n * inv_g), norm * (b0n + b1n * (tau + inv_g))
    cm0, cmb = norm * (b0n - b1n * inv_g), norm * (b0n + b1n * (tau - inv_g))
    Ssfc = emissivity[..., None] * PI * bplanck[..., -1:]
    E_ev, E_od = _rhs(e1, e2, e3, e4, cp0, cpb, cm0, cmb, Rsfc, Ssfc)
    y1, y2 = (y[0] for y in _solve(e1, e2, e3, e4, Rsfc, E_ev[None], E_od[None]))
    fup = torch.cat([y1[..., :1] * e3[..., :1] - y2[..., :1] * e4[..., :1] + cp0[..., :1],
                     y1 * e1 + y2 * e2 + cpb], -1)
    fdn = torch.cat([torch.zeros_like(tau[..., :1]), y1 * e3 + y2 * e4 + cmb], -1)
    return fup, fdn


def _planck(nu, T):
    x = (PLANK * nu) / (K_BOLTZ_SI * T)
    return 2.0e3 * (PLANK * nu / C_LIGHT) * (nu / C_LIGHT) * nu / torch.expm1(x)


def fluxes(c, T_surf, P, T, dens, dz, pdens=None, radii=None):
    """Frequency-integrated (fup_ir, fdn_ir, fup_sol, fdn_sol), each (B, nz+1)
    ground-up, mW/m^2, of ground-up columns (see :func:`opacity`)."""
    tau, w0, g = opacity(c, P, T, dens, dz, pdens, radii)
    B, _, G, nz = tau.shape
    rows = lambda x, nw: x.expand((B, nw, G) + x.shape[3:]).reshape(B * nw * G, *x.shape[3:])
    red = lambda x, nw: torch.einsum("wgk,g->wk", x.reshape(-1, G, x.shape[-1]), c.wbin)
    ground_up = lambda x, nw: torch.flip(x.reshape(B, nw, nz + 1), dims=[-1]).transpose(1, 2)

    def integrate(fa, f0, f1):
        dfreq = c.freq[f0:f1 + 2][:-1] - c.freq[f0:f1 + 2][1:]
        return torch.sum(fa * dfreq, dim=-1)

    i0, i1 = c.ir
    nw = i1 - i0 + 1
    freq = c.freq[i0:i1 + 2]
    avg = 0.5 * (freq[:-1] + freq[1:])
    bpl = torch.cat([_planck(avg[None, :, None], torch.flip(T, dims=[1])[:, None, :]),
                     _planck(avg[None, :, None], T_surf[:, None, None])], dim=-1)
    emis = torch.full((B * nw * G,), c.emissivity, dtype=tau.dtype, device=tau.device)
    fup, fdn = two_stream_ir(rows(tau[:, i0:i1 + 1], nw), rows(w0[:, i0:i1 + 1], nw),
                             rows(g[:, i0:i1 + 1, None, :], nw), emis, c.ir_tau_min,
                             rows(bpl[:, :, None, :], nw))
    fup_ir = integrate(ground_up(red(fup, nw), nw), i0, i1)
    fdn_ir = integrate(ground_up(red(fdn, nw), nw), i0, i1)

    s0, s1 = c.sol
    nw = s1 - s0 + 1
    alb = torch.full((B * nw * G,), c.albedo, dtype=tau.dtype, device=tau.device)
    fup, fdn = two_stream_solar(rows(tau[:, s0:s1 + 1], nw), rows(w0[:, s0:s1 + 1], nw),
                                rows(g[:, s0:s1 + 1, None, :], nw), c.zen_u, alb)
    zred = lambda x: torch.einsum("zwgk,g,z->wk", x.reshape(len(c.zen_u), -1, G, x.shape[-1]),
                                  c.wbin, c.zen_w)
    scale = (c.photons * c.diurnal)[None, :, None]
    sol = lambda x: integrate(ground_up(zred(x).reshape(B, nw, nz + 1) * scale, nw), s0, s1)
    return fup_ir, fdn_ir, sol(fup), sol(fdn)
