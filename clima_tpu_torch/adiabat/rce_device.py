"""Batched radiative-convective equilibrium over column ensembles, on the model's device.

The port of ``clima_tpu/adiabat/rce_device.py``. The host solver
(:mod:`.rce`) follows ``src/adiabat/clima_adiabat_solve.f90`` with numpy zone
bookkeeping, HYBRJ/PTC and serial mask updates, one column per call. This
module poses the whole RCE loop over a batch of columns ("lanes") that stays
on the device: each objective evaluation is one batched RC march, one
opacity assembly (RORR) and one IR and one solar two-stream call over every
lane, and each finite-difference Jacobian one batched IR call over every
lane's perturbed columns.

Design, as in the JAX package:

* **Fixed-size masked DOF vector.** The unknown is always the full (nz+1)
  temperature vector [T_surf, T_1..T_nz]; rows whose layer convects with
  below ("slaved" rows) carry residual 0 and an identity Jacobian column, so
  the embedded linear system is the reference's reduced system
  (solve.f90:868-877) padded to a fixed shape. After every rebuild the slaved
  entries take the adiabat temperatures.
* **Zone sums over labels.** The per-zone flux and heat-capacity sums
  (solve.f90:1212-1327) are sums over the zone labels ``cumsum(~conv) - 1``,
  written as a one-hot (lane, row, zone) contraction: deterministic on the
  card, where float64 atomics (``index_add_``) would make the
  cancellation-sensitive residual differ from run to run.
* **Batched-IR finite-difference Jacobian** on frozen opacity and frozen
  solar parts (solve.f90:768-822): every lane's n+1 zone-block perturbations
  in one IR call, or in groups of ``jac_chunk`` per lane.
* **One damped-Newton/PTC stage loop** for the three strategies
  (solve.f90:259-303) with the seed ladder 0, -1, +2, -3 K, backtracking,
  TSPSEUDO dt growth (clima_ptc.f90:744-770) and the max|F/F0| < xtol_rc
  test (solve.f90:620-646).
* **Mask updates as array operations** (modes 1/2/3, solve.f90:899-1112, and
  the boundary limiter, :1118-1210) by run labelling and zone reductions.

Where the JAX package writes each function for one column and batches it
with ``vmap`` under ``while_loop``s, here every function takes a leading lane
axis and each loop is a Python loop over a fixed (B, ...) lane state: the
lanes still stepping take the new values with ``torch.where``, the others
keep theirs, and the loop ends on one host test per iteration that no lane
is left. Work whose result every lane would discard (a solve no lane
performs, a mask mode no lane is in, a trial step for a lane that has
converged) is skipped. The march replays the model's cached interval graph
on the card (:func:`.profile_rc.make_profile_rc_core`), captured once per
batch size. The df64 flux path of the JAX package is not ported: float64
accumulation takes its place (``flux_precision``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as const
from ..config.species import heat_capacity
from ..ops.interp import pdot
from ..parallel.solvers import _no_mesh
from ..physics import eqns
from ..radtran.opacity import compute_opacity
from ..radtran.radiate import radiate_ir, radiate_solar
from ..utils.errors import ClimaException
from .altitude import compute_altitude_core
from .profile_rc import make_profile_rc_core
from .rce import _custom_mix

__all__ = ["build_rce_fns", "batched_rce"]

# solver stage kinds
_NEWTON = 0
_PTC = 1

# reference retry ladder: perturbation = +k for even k, -k for odd k,
# giving 0, -1, +2, -3 (clima_adiabat_solve.f90:405-411)
_SEED_PERTS = np.array([0.0, -1.0, 2.0, -3.0])


def _fmt_lanes(*arrs):
    """Row-major lane formatting of per-lane values."""
    a = [np.atleast_1d(np.asarray(x.cpu() if torch.is_tensor(x) else x)) for x in arrs]
    return a, a[0].shape[0]


def _verbose_solver_line(it, kind, accepted, ratio, fnorm, tmax, tmin):
    (it, kind, accepted, ratio, fnorm, tmax, tmin), n = _fmt_lanes(
        it, kind, accepted, ratio, fnorm, tmax, tmin
    )
    for l in range(n):
        lane = f"[{l}] " if n > 1 else ""
        stage = "PTC " if int(kind[l]) == _PTC else "NEWT"
        print(
            f"   {lane}it ={int(it[l]):5d}  {stage}  "
            f"acc={str(bool(accepted[l])):5s}  "
            f"max|F/F0| = {float(ratio[l]):9.2e}  "
            f"|dT/dt| = {float(fnorm[l]):9.2e}  "
            f"max(T) = {float(tmax[l]):7.1f}  min(T) = {float(tmin[l]):7.1f}",
            flush=True,
        )


def _verbose_outer_line(it, mode, changed, solve_ok, its):
    (it, mode, changed, solve_ok, its), n = _fmt_lanes(it, mode, changed, solve_ok, its)
    for l in range(n):
        lane = f"[{l}] " if n > 1 else ""
        print(
            f"{lane}rc_iter ={int(it[l]):3d}  mode ={int(mode[l]):2d}  "
            f"mask_changed={str(bool(changed[l])):5s}  "
            f"solve_ok={str(bool(solve_ok[l])):5s}  "
            f"solve_iters ={int(its[l]):5d}",
            flush=True,
        )


def _where(mask, new, old):
    """torch.where over (nested dicts of) per-lane tensors, mask (B,)."""
    if isinstance(new, dict):
        return {k: _where(mask, new[k], old[k]) for k in new}
    return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), new, old)


def _lanes(x, idx):
    """The lanes ``idx`` of (nested dicts of) per-lane tensors."""
    if isinstance(x, dict):
        return {k: _lanes(v, idx) for k, v in x.items()}
    return x[idx]


def _linsolve(A, b):
    """A x = b per lane, A (B, n, n), b (B, n); non-finite where A is
    singular, as the JAX package's LU solve returns there."""
    x, info = torch.linalg.solve_ex(A, b[..., None])
    x = x[..., 0]
    ok = (info == 0)[:, None] & torch.isfinite(x).all(dim=-1, keepdim=True)
    return torch.where(ok, x, torch.nan)


def _interp_cols(x, xp, fp):
    """jnp.interp(x, xp, fp[:, j]) for every column j: x (B, nz), xp (nP,)
    ascending, fp (nP, np) -> (B, nz, np), clamped outside xp."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    f = f0 + ((x - x0) / (x1 - x0))[..., None] * (f1 - f0)
    f = torch.where((x < xp[0])[..., None], fp[0], f)
    return torch.where((x > xp[-1])[..., None], fp[-1], f)


def build_rce_fns(c, max_newton_iters=40, max_ptc_steps=300, max_total_iters=600,
                  max_line_search=8, record_trace=False, flux_precision="auto",
                  verbose=False, jac_chunk=None):
    """Build the batched RCE functions from an AdiabatClimate, on ``c.device``.

    All configuration (tolerances, hysteresis knobs, strategy, opacity data)
    is read from ``c`` at build time; changing knobs on ``c`` afterwards
    requires rebuilding. Every function takes a leading lane axis B: x
    (B, nz+1), masks (B, nz), P_i_surf (B, ng).

    ``verbose=True`` prints a solver line per inner iteration and an outer
    line per RC iteration, every lane on its own line (the reference's
    printout, clima_adiabat_solve.f90:495-500).

    ``flux_precision``: ``"standard"`` accumulates the cancellation-prone
    flux residual in the model's dtype; ``"auto"`` (default) and ``"df64"``
    accumulate it in float64 (the JAX package's float32-pair path, for TPUs
    without float64, is not ported: the card has float64).

    ``jac_chunk`` bounds how many of each lane's n+1 FD Jacobian evaluations
    go through one IR call: None (default) takes all of them at once, an
    integer m runs groups of m per lane (B*m columns per call) in turn.

    Returns a dict of functions; the main entry is
    ``rce(x0, conv0, use_guess, P_i_surf) -> result dict``.
    """
    if not c.double_radiative_grid:
        raise ClimaException("device RCE requires double_radiative_grid=True")
    if flux_precision not in ("auto", "standard", "df64"):
        raise ClimaException("flux_precision must be auto/standard/df64")
    acc = c.dtype if flux_precision == "standard" else torch.float64
    # Tidally-locked dayside: the Koll (2022) heat-redistribution factor 4f
    # scales the solar fluxes (clima_adiabat.f90:986-1009, :1322-1395), a
    # smooth function of the current state.
    tl = bool(c.tidally_locked_dayside)
    # compute_solar_in_jac=True (solve.f90:768-822): solar RT on frozen
    # opacity does not depend on temperature, so re-running it per
    # perturbation changes the fluxes only through the Koll factor, which
    # the Jacobian re-evaluates per perturbation on the frozen solar parts.
    solar_jac = bool(c.compute_solar_in_jac)

    par = dataclasses.replace(c._par, P_top=float(c.P_top))
    nz = c.nz
    n = nz + 1
    dev = c.device
    t = c._tensor
    RH = t(c.RH)
    cm = _custom_mix(c)
    graphs = c._rc_graphs

    rad = c.rad
    op = rad.op
    ir_slice = (rad.ir.ind_start, rad.ir.ind_end)
    sol_slice = (rad.sol.ind_start, rad.sol.ind_end)
    freq_master, wavl_master, wbin = op.freq, op.wavl, op.kset.wbin
    emissivity = t(rad.surface_emissivity)
    albedo = t(rad.surface_albedo)
    photons = t(rad.photons_sol * rad.photon_scale_factor)
    zenith_u = t(rad.zenith_u)
    zenith_w = t(rad.zenith_weights)
    diurnal = float(rad.diurnal_fac)
    has_hard = bool(rad.has_hard_surface)
    ir_tau_min = float(rad.ir_tau_min)
    gas_masses = par.gas_masses
    freq_ir = freq_master[ir_slice[0]: ir_slice[1] + 2]
    freq_sol = freq_master[sol_slice[0]: sol_slice[1] + 2]

    np_ = c.sp.np_
    if np_ > 0:
        pl_logP = t(c._particle_log10P)
        pl_dens = t(c._particle_log10_dens)
        pl_radii = t(c._particle_log10_radii)

    if tl:
        tl_L, tl_chi, tl_nLW, tl_Cd = float(c.L), float(c.chi), float(c.n_LW), float(c.Cd)
        tl_grav = float(eqns.gravity(c.planet_radius, c.planet_mass, 0.0))
        tl_bol = float(rad.bolometric_flux())
        _wavl_ir = np.asarray(rad.ir.wavl, np.float64)
        _freq_ir = np.asarray(rad.ir.freq, np.float64)
        tl_dlam = t(_wavl_ir[1:] - _wavl_ir[:-1])
        _avg_freq = 0.5 * (_freq_ir[:-1] + _freq_ir[1:])
        _avg_lam = const.c_light * 1.0e9 / _avg_freq
        tl_avg_freq = t(_avg_freq)
        tl_bp_scale = t(_avg_freq / _avg_lam)

    epsj = float(c.epsj)
    xtol_rc = float(c.xtol_rc)
    shf = float(c.surface_heat_flow)
    # characteristic flux (solve.f90:620-634)
    char = max(abs(rad.bolometric_flux() / 4.0 + shf * 1.0e-3), 1.0e-6)
    dt_increment = float(c.dt_increment)
    strategy = int(c.rce_solve_strategy)
    hyst_on = float(c.convective_hysteresis_frac_on)
    hyst_off = float(c.convective_hysteresis_frac_off)
    hyst_min = float(c.convective_hysteresis_min)
    shift = int(c.convective_max_boundary_shift)
    newton_step_size = float(c.convective_newton_step_size)
    max_rc_iters = int(c.max_rc_iters)
    max_rc_iters_convection = int(c.max_rc_iters_convection)
    require_mode2 = bool(c.require_mode2)
    prevent_overconvection = bool(c.prevent_overconvection)
    ref_pressure = float(c.reference_pressure)

    # stage list per strategy (solve.f90:259-303)
    if strategy == 1:
        stage_kinds = [_NEWTON]
    elif strategy == 2:
        stage_kinds = [_PTC, _NEWTON]
    elif strategy == 3:
        stage_kinds = [_NEWTON, _PTC, _NEWTON]
    else:
        raise ClimaException("Invalid rce_solve_strategy.")
    n_stages = len(stage_kinds)
    stage_kinds_t = torch.tensor(stage_kinds, device=dev)
    seed_perts = t(_SEED_PERTS)
    idx_layers = torch.arange(nz, device=dev)
    zones = torch.arange(n, device=dev)

    # ------------------------------------------------------------------
    # profile rebuild (no RT)
    # ------------------------------------------------------------------

    def rebuild(x, conv, P_i_surf):
        """make_profile_rc + altitude + densities + particles; no RT."""
        out = make_profile_rc_core(par, RH, x[:, 0], x[:, 1:], P_i_surf, conv, cm,
                                   graphs=graphs)
        P_c = out["P_e"][:, 1::2]
        T_c = out["T"]
        f_c = out["f_i_e"][:, 1::2]
        mubar = pdot(f_c, gas_masses)
        mubar_surf = pdot(out["f_i_e"][:, 0], gas_masses)
        alt = compute_altitude_core(
            P_c, T_c, mubar, out["P_surf"], x[:, 0], mubar_surf, par.P_top,
            par.planet_mass, par.planet_radius, ref_pressure,
        )
        density = P_c / (const.k_boltz * T_c)
        dens = f_c * density[..., None]
        lr_e = out["lapse_rate_e"]
        # edge->layer mapping of the intended adiabat (rce.make_profile_rc)
        lr_intended = torch.cat([lr_e[:, :1], lr_e[:, 1:-1:2][:, : nz - 1]], dim=1)
        x_model = torch.cat([x[:, :1], T_c], dim=1)
        # actual lapse rate dlnT/dlnP (adiabat._set_lapse_rates), as
        # log1p of the exact difference over the value: near-zero lapse
        # rates (an isothermal radiative top) stay near zero
        P_full = torch.cat([out["P_surf"][:, None], P_c], dim=1)
        dlnT = torch.log1p(torch.diff(x_model, dim=1) / x_model[:, :-1])
        dlnP = torch.log1p(torch.diff(P_full, dim=1) / P_full[:, :-1])
        prof = dict(
            P_surf=out["P_surf"], P_c=P_c, T_c=T_c, f_c=f_c, dz=alt["dz"], dens=dens,
            x_model=x_model, lr_intended=lr_intended, lr_actual=dlnT / dlnP,
            N_surface=out["N_surface"], z=alt["z"],
        )
        if np_ > 0:
            lg = torch.log10(P_c)
            prof["pdens"] = 10.0 ** _interp_cols(lg, pl_logP, pl_dens)
            prof["pradii"] = 10.0 ** _interp_cols(lg, pl_logP, pl_radii)
        return prof

    def to_radiative_grid(a):
        """Doubled grid + 2 ghost layers (clima_adiabat.f90:729-773), layer axis 1."""
        return torch.cat([torch.repeat_interleave(a, 2, dim=1), a[:, -1:], a[:, -1:]], dim=1)

    # ------------------------------------------------------------------
    # RT + cancellation-safe edge flux assembly
    # ------------------------------------------------------------------

    def _net_edge_parts(fup_a, fdn_a, freq_channel):
        """(base (B,), d (B, nz)): net flux at physical edge 0 and its exact
        edge deltas, accumulated in ``acc``."""
        net = (fdn_a - fup_a)[:, 0::2][:, :n]  # physical edges, ground-up
        dfreq = (freq_channel[:-1] - freq_channel[1:]).to(acc)
        base = torch.sum(net[:, 0].to(acc) * dfreq, dim=-1)
        d = torch.sum(torch.diff(net, dim=1).to(acc) * dfreq, dim=-1)
        return base, d

    def ir_parts(opr, T_surf, T_r):
        ir = radiate_ir(ir_slice, freq_master, wbin, opr, emissivity, has_hard, ir_tau_min,
                        T_surf, T_r)
        return _net_edge_parts(ir["fup_a"], ir["fdn_a"], freq_ir)

    def sol_parts(opr):
        """(base, d) for the solar channel; tidally locked, also
        (fup_toa, fdn_toa), the bond-albedo inputs."""
        sol = radiate_solar(sol_slice, freq_master, wavl_master, wbin, opr, albedo, diurnal,
                            photons, zenith_u, zenith_w, compute_amean=False)
        parts = _net_edge_parts(sol["fup_a"], sol["fdn_a"], freq_sol)
        if not tl:
            return parts
        dfreq = freq_sol[:-1] - freq_sol[1:]
        fup_toa = torch.sum(sol["fup_a"][:, -1] * dfreq, dim=-1)  # ground-up: -1 = TOA
        fdn_toa = torch.sum(sol["fdn_a"][:, -1] * dfreq, dim=-1)
        return parts[0], parts[1], fup_toa, fdn_toa

    def rad_enhancement(opr, T_surf, f_surf, P_surf, bond_albedo):
        """Koll (2022) 4f solar enhancement from the current state, per lane
        (AdiabatClimate.heat_redistribution_parameters, clima_adiabat.f90:1322-1395)."""
        # band optical depth summed over the radiative column, (B, nw_ir)
        tau_lambda = torch.sum(opr["tau_band"][:, ir_slice[0]: ir_slice[1] + 1], dim=2)
        bplank = eqns.planck_fcn(tl_avg_freq, T_surf[:, None]) * tl_bp_scale
        num = torch.sum(torch.exp(-tau_lambda) * bplank * tl_dlam, dim=-1)
        den = torch.sum(bplank * tl_dlam, dim=-1)
        tau_LW = -torch.log(num / den)
        Teq = eqns.equilibrium_temperature(tl_bol, bond_albedo)
        mubar = pdot(f_surf, gas_masses)
        cp_i = heat_capacity(par.thermo, T_surf)
        cp = torch.sum(cp_i * f_surf, dim=-1) * (1.0 / (mubar * 1.0e-3)) * 1.0e4
        k_term = eqns.k_term_heat_redistribution(tl_L, tl_grav, tl_chi, mubar, cp, tl_nLW,
                                                 tl_Cd)
        return 4.0 * eqns.f_heat_redistribution(tau_LW, P_surf, Teq, k_term)

    def column_opacity(prof, T_r):
        pdens_r = to_radiative_grid(prof["pdens"]) if np_ > 0 else None
        prad_r = to_radiative_grid(prof["pradii"]) if np_ > 0 else None
        return compute_opacity(
            op, to_radiative_grid(prof["P_c"]) / 1.0e6, T_r, to_radiative_grid(prof["dens"]),
            to_radiative_grid(0.5 * prof["dz"]), pdens_r, prad_r,
        )

    def assemble_f_total(b_ir, d_ir, b_sol, d_sol):
        """f_total (B, n) at physical edges, ground-up, + surface heat flow at [0]."""
        f0 = (b_ir + b_sol + shf)[:, None]
        return torch.cat([f0, f0 + torch.cumsum(d_ir + d_sol, dim=1)], dim=1)

    # ------------------------------------------------------------------
    # masked residual assembly (solve.f90:648-739, 1212-1327)
    # ------------------------------------------------------------------

    def _zone_sum(v, seg):
        """Sum of v (B, n) over each row's zone, (B, n) by zone label: a
        one-hot contraction, deterministic on every device."""
        onehot = seg[:, :, None] == zones
        return torch.sum(torch.where(onehot, v[:, :, None], 0.0), dim=1)

    def residuals(x_model, conv, f_total, f_c, P_c, dz):
        """dFdt and dTdt (B, n) per DOF row; slaved rows carry 0."""
        conv_t = torch.cat([torch.zeros_like(conv[:, :1]), conv], dim=1)  # (B, n)
        fluxes = torch.cat([f_total[:, :1], torch.diff(f_total, dim=1)], dim=1)
        T = x_model[:, 1:]
        density = P_c / (const.k_boltz * T)
        mubar = pdot(f_c, gas_masses)
        rho = density * (1.0 / const.N_avo) * mubar
        cp_i = heat_capacity(par.thermo, T)
        cp = torch.sum(cp_i * f_c, dim=-1) * (1.0 / (mubar * 1.0e-3)) * 1.0e4
        c_layer = rho * cp * dz
        c_row = torch.cat([c_layer[:, :1], c_layer], dim=1)  # row 0 = surface slab
        seg = torch.cumsum(~conv_t, dim=1) - 1  # zone label per row
        Fseg = torch.gather(_zone_sum(fluxes.to(c_row.dtype), seg), 1, seg)
        Cseg = torch.gather(_zone_sum(c_row, seg), 1, seg)
        is_dof = ~conv_t
        dFdt = torch.where(is_dof, Fseg, 0.0)
        dTdt = torch.where(is_dof, Fseg / torch.clamp(Cseg, min=1e-300), 0.0)
        return dFdt, dTdt

    def flux_ratio(dFdt):
        """max|F/F0| per lane (solve.f90:620-634)."""
        return torch.amax(torch.abs(dFdt), dim=-1) * 1.0e-3 / char

    # ------------------------------------------------------------------
    # objective + Jacobian
    # ------------------------------------------------------------------

    def objective(x, conv, P_i_surf):
        """Full objective: rebuild, radiate, masked residuals.

        Returns (x_model, dFdt, dTdt, aux); aux carries what the
        frozen-opacity Jacobian, the mask updates and the result need.
        """
        prof = rebuild(x, conv, P_i_surf)
        x_model = prof["x_model"]
        T_r = to_radiative_grid(x_model[:, 1:])
        opr = column_opacity(prof, T_r)
        b_ir, d_ir = ir_parts(opr, x_model[:, 0], T_r)
        if tl:
            b_sol, d_sol, fup_toa, fdn_toa = sol_parts(opr)
            alb = fup_toa / fdn_toa
            enh = rad_enhancement(opr, x_model[:, 0], prof["f_c"][:, 0], prof["P_surf"], alb)
            b_sol = b_sol * enh
            d_sol = d_sol * enh[:, None]
        else:
            b_sol, d_sol = sol_parts(opr)
        f_total = assemble_f_total(b_ir, d_ir, b_sol, d_sol)
        dFdt, dTdt = residuals(x_model, conv, f_total, prof["f_c"], prof["P_c"], prof["dz"])
        aux = dict(
            opr=opr, b_sol=b_sol, d_sol=d_sol, f_c=prof["f_c"], P_c=prof["P_c"],
            dz=prof["dz"], z=prof["z"], P_surf=prof["P_surf"], N_surface=prof["N_surface"],
            lr_intended=prof["lr_intended"], lr_actual=prof["lr_actual"], f_total=f_total,
        )
        if tl:
            # the Jacobian's solar recompute rescales the enhancement-scaled
            # solar parts by the Koll factor at the perturbed T_surf
            aux["enh"] = enh
            aux["alb"] = alb
        return x_model, dFdt, dTdt, aux

    def _dTdt_frozen(T_all, conv, aux):
        """dTdt (B, m, n) at the temperatures T_all (B, m, n) of each lane,
        on the lane's frozen opacity and solar parts: one IR call over B*m
        columns."""
        B, m, _ = T_all.shape
        rep = lambda v: torch.repeat_interleave(v, m, dim=0)
        opr = {k: rep(v) for k, v in aux["opr"].items()}
        Ts, T_lay = T_all[..., 0].reshape(B * m), T_all[..., 1:].reshape(B * m, nz)
        b_ir, d_ir = ir_parts(opr, Ts, to_radiative_grid(T_lay))
        b_sol, d_sol = rep(aux["b_sol"]), rep(aux["d_sol"])
        if tl and solar_jac:
            f_surf = rep(aux["f_c"][:, 0])
            enh_p = rad_enhancement(opr, Ts, f_surf, rep(aux["P_surf"]), rep(aux["alb"]))
            scale = enh_p / rep(aux["enh"])
            b_sol = b_sol * scale
            d_sol = d_sol * scale[:, None]
        f_total = assemble_f_total(b_ir, d_ir, b_sol, d_sol)
        _, dTdt = residuals(T_all.reshape(B * m, n), rep(conv), f_total, rep(aux["f_c"]),
                            rep(aux["P_c"]), rep(aux["dz"]))
        return dTdt.reshape(B, m, n)

    def jacobian(x_model, conv, aux, dTdt_base):
        """Zone-block FD Jacobian (B, n, n) on frozen opacity and solar
        (solve.f90:768-822).

        The FD base is re-evaluated through the same flux path as the
        perturbed points, as evaluation 0 of each lane; ``dTdt_base`` (from
        the full objective) is not used, as in the JAX package.
        """
        del dTdt_base
        conv_t = torch.cat([torch.zeros_like(conv[:, :1]), conv], dim=1)
        seg = torch.cumsum(~conv_t, dim=1) - 1
        deltas = epsj * torch.abs(x_model)  # (B, n)
        block = seg[:, None, :] == seg[:, :, None]  # (B, n pert, n row)
        T_all = torch.cat([x_model[:, None, :],
                           x_model[:, None, :] + deltas[:, :, None] * block], dim=1)
        m = n + 1 if jac_chunk is None else max(1, min(int(jac_chunk), n + 1))
        dTdt_all = torch.cat([_dTdt_frozen(T_all[:, i:i + m], conv, aux)
                              for i in range(0, n + 1, m)], dim=1)  # (B, n+1, n)
        cols = (dTdt_all[:, 1:] - dTdt_all[:, :1]) / deltas[:, :, None]
        J = cols.transpose(1, 2)  # J[:, :, j] = d dTdt / d x_j
        # slaved columns -> identity (the embedded reduced system)
        eye = torch.eye(n, dtype=J.dtype, device=dev)
        return torch.where(conv_t[:, None, :], eye, J)

    # ------------------------------------------------------------------
    # unified Newton/PTC stage loop (solve.f90:259-303, 379-618)
    # ------------------------------------------------------------------

    def _valid_temps(x):
        return (torch.isfinite(x) & (x > 0.5) & (x < 6000.0)).all(dim=-1)

    def solve_strategy(x0, conv, P_i_surf, lanes=None):
        """Run the stage sequence to max|F/F0| < xtol_rc on the lanes
        ``lanes`` (B,) bool (all when None); the other lanes come back
        unchanged. Returns (x, ok, iters, diag)."""
        xm0, dFdt0, dTdt0, aux0 = objective(x0, conv, P_i_surf)
        B = x0.shape[0]
        norm0 = torch.linalg.vector_norm(dTdt0, dim=-1)
        izero = torch.zeros(B, dtype=torch.int64, device=dev)
        false = torch.zeros(B, dtype=torch.bool, device=dev)
        st = dict(
            x=xm0, dFdt=dFdt0, dTdt=dTdt0, aux=aux0, norm=norm0, x_seed=xm0, stage=izero,
            k_seed=izero, attempt_it=izero, it=izero, dt=torch.zeros_like(norm0),
            fnorm_prev=norm0, ok=false, x_best=xm0, ratio_best=flux_ratio(dFdt0),
        )
        done = false if lanes is None else ~lanes

        while bool((~done).any()):
            active = ~done
            kind = stage_kinds_t[torch.clamp(st["stage"], 0, n_stages - 1)]
            is_ptc = kind == _PTC
            ratio = flux_ratio(st["dFdt"])
            converged = ratio < xtol_rc

            # stage/seed budgets
            budget = torch.where(is_ptc, max_ptc_steps, max_newton_iters)
            attempt_exhausted = st["attempt_it"] >= budget
            # Newton retries from perturbed seeds (0,-1,+2,-3 K); PTC has no
            # retry ladder (clima_adiabat_solve.f90:405-436 vs 506-618)
            can_retry = (~is_ptc) & (st["k_seed"] < 3)
            do_reset = attempt_exhausted & can_retry & ~converged
            # stage advance BEFORE stepping: this attempt's budget is spent
            advance_pre = attempt_exhausted & ~can_retry & ~converged

            # a converged lane discards its Jacobian and trial step: when
            # every stepping lane has converged, neither is computed
            stepping = active & ~converged
            ts = dict(alpha=torch.ones_like(ratio), accepted=false, was_reset=false,
                      tries=izero, x=st["x"], dFdt=st["dFdt"], dTdt=st["dTdt"],
                      aux=st["aux"], norm=st["norm"])
            dt0 = torch.zeros_like(ratio)
            if bool(stepping.any()):
                J = jacobian(st["x"], conv, st["aux"], st["dTdt"])
                d_newton = _linsolve(J, -st["dTdt"])
                # PTC dt0 = 0.1/max|diag J| on stage entry (clima_ptc.f90:332-360)
                maxdiag = torch.amax(torch.abs(torch.diagonal(J, dim1=1, dim2=2)), dim=-1)
                dt0 = torch.clamp(0.1 / torch.clamp(maxdiag, min=1e-300), max=1.0e12)
                eye = torch.eye(n, dtype=J.dtype, device=dev)
                # a PTC stage with no dt yet (strategy 2 starts with PTC) gets dt0
                ts["dt"] = torch.where(is_ptc & (st["dt"] <= 0.0), dt0, st["dt"])
                # the trial loop (backtracking for Newton, dt halving for
                # PTC); a lane advancing its stage discards its trial too
                trying = stepping & ~advance_pre
                while True:
                    t_active = trying & ~ts["accepted"] & (ts["tries"] < max_line_search)
                    if not bool(t_active.any()):
                        break
                    alpha, dtt = ts["alpha"], ts["dt"]
                    s_ptc = _linsolve(eye / torch.clamp(dtt, min=1e-300)[:, None, None] - J,
                                      st["dTdt"])
                    last_try = ts["tries"] == max_line_search - 1
                    # final Newton try: restart from the perturbed seed
                    reset_now = (do_reset | (last_try & ~is_ptc & can_retry)) & ~is_ptc
                    x_try = torch.where(
                        reset_now[:, None],
                        st["x_seed"] + seed_perts[torch.clamp(st["k_seed"], 0, 3)][:, None],
                        st["x"] + torch.where(is_ptc[:, None], s_ptc,
                                              alpha[:, None] * d_newton),
                    )
                    # lanes not trying evaluate their current state
                    x_try = torch.where(t_active[:, None], x_try, st["x"])
                    xm, dFdt_t, dTdt_t, aux_t = objective(x_try, conv, P_i_surf)
                    norm_t = torch.linalg.vector_norm(dTdt_t, dim=-1)
                    finite = torch.isfinite(norm_t) & _valid_temps(xm)
                    ratio_t = flux_ratio(dFdt_t)
                    # accept: PTC accepts any finite step (clima_ptc.f90
                    # rejects only on a non-finite residual); Newton needs a
                    # norm decrease, a converged trial, or a seed reset
                    accept = finite & (is_ptc | (norm_t < st["norm"]) | (ratio_t < xtol_rc)
                                       | reset_now)
                    new = dict(
                        alpha=torch.where(accept, alpha, alpha * 0.5),
                        dt=torch.where(accept | ~is_ptc, dtt,
                                       torch.clamp(dtt * 0.5, min=1e-300)),
                        accepted=accept, was_reset=reset_now & accept, tries=ts["tries"] + 1,
                        x=_where(accept, xm, ts["x"]), dFdt=_where(accept, dFdt_t, ts["dFdt"]),
                        dTdt=_where(accept, dTdt_t, ts["dTdt"]),
                        aux=_where(accept, aux_t, ts["aux"]),
                        norm=torch.where(accept, norm_t, ts["norm"]),
                    )
                    ts = _where(t_active, new, ts)
            else:
                ts["dt"] = st["dt"]

            # stage advance AFTER stepping: no acceptable step exists at this
            # stage (the reference moves to the next strategy stage)
            advance = advance_pre | (~ts["accepted"] & ~converged)
            stage_new = st["stage"] + advance.long()
            out_of_stages = stage_new >= n_stages
            entering_ptc = advance & ~out_of_stages & (
                stage_kinds_t[torch.clamp(stage_new, 0, n_stages - 1)] == _PTC)

            # freeze the state when converged or advancing (the trial result
            # of a spent attempt is discarded; the next stage restarts from
            # the current point, matching run_hybrj -> run_ptc chaining)
            keep = converged | advance
            x_out = _where(keep, st["x"], ts["x"])
            dFdt_out = _where(keep, st["dFdt"], ts["dFdt"])
            dTdt_out = _where(keep, st["dTdt"], ts["dTdt"])
            aux_out = _where(keep, st["aux"], ts["aux"])
            norm_out = torch.where(keep, st["norm"], ts["norm"])

            # TSPSEUDO growth on acceptance (clima_ptc.f90:744-770)
            grow = is_ptc & ts["accepted"] & ~keep
            dt_next = torch.where(
                entering_ptc, dt0,
                torch.where(grow, dt_increment * ts["dt"] * st["fnorm_prev"]
                            / torch.clamp(ts["norm"], min=1e-300), ts["dt"]))

            it = st["it"] + 1
            ratio_out = flux_ratio(dFdt_out)
            if verbose:
                _verbose_solver_line(it, kind, ts["accepted"], ratio_out, norm_out,
                                     torch.amax(x_out, dim=-1), torch.amin(x_out, dim=-1))
            new = dict(
                x=x_out, dFdt=dFdt_out, dTdt=dTdt_out, aux=aux_out, norm=norm_out,
                x_seed=_where(advance, x_out, st["x_seed"]),
                stage=stage_new,
                k_seed=torch.where(advance, 0, st["k_seed"] + ts["was_reset"].long()),
                attempt_it=torch.where(ts["was_reset"] | advance, 0, st["attempt_it"] + 1),
                it=it,
                dt=dt_next,
                fnorm_prev=torch.where(entering_ptc, norm_out,
                                       torch.where(grow, ts["norm"], st["fnorm_prev"])),
                ok=converged,
                x_best=_where(ratio_out < st["ratio_best"], x_out, st["x_best"]),
                ratio_best=torch.minimum(ratio_out, st["ratio_best"]),
            )
            st = _where(active, new, st)
            finished = converged | (advance & out_of_stages) | (it >= max_total_iters)
            done = done | (active & finished)

        # the pre-loop evaluation may already satisfy the tolerance
        ok = st["ok"] | (flux_ratio(st["dFdt"]) < xtol_rc)
        # on failure hand back the best iterate seen, not wherever the last
        # stage wandered
        x_ret = _where(ok, st["x"], st["x_best"])
        # out_of_stages: every strategy stage spent its budget without
        # reaching the tolerance (the terminal signature of an unreachable
        # tolerance)
        diag = dict(ratio_best=st["ratio_best"], it_total=st["it"],
                    out_of_stages=st["stage"] >= n_stages)
        return x_ret, ok, st["it"], diag

    # ------------------------------------------------------------------
    # zone labelling + mask limiter (solve.f90:1118-1210)
    # ------------------------------------------------------------------

    def _runs(mask):
        """Label maximal True-runs of each lane's mask (B, nz): (zid_eff,
        lo_z, hi_z, valid_z), rows outside a run labelled nz."""
        start = mask & ~torch.cat([torch.zeros_like(mask[:, :1]), mask[:, :-1]], dim=1)
        zid = torch.cumsum(start, dim=1) - 1
        zid_eff = torch.where(mask, zid, nz)
        onehot = zid_eff[:, :, None] == torch.arange(nz, device=dev)  # (B, row, zone)
        rows = idx_layers[None, :, None]
        big = torch.iinfo(torch.int32).max
        lo_z = torch.where(onehot, rows, big).amin(dim=1)
        hi_z = torch.where(onehot, rows, -big - 1).amax(dim=1)
        return zid_eff, lo_z, hi_z, lo_z <= hi_z

    def _zone_max(values, zid):
        """max of values (B, nz) over each run label (B, nz) -> (B, nz), -inf
        for labels without rows."""
        onehot = zid[:, :, None] == torch.arange(nz, device=dev)
        return torch.where(onehot, values[:, :, None], -torch.inf).amax(dim=1)

    def _take(a, i):
        """a (B, nz) at clip(i, 0, nz-1) per lane and zone."""
        return torch.gather(a, 1, torch.clamp(i, 0, nz - 1))

    def _window_any(values, starts, count, valid):
        """any(values[starts + s] for s in 0..count-1), all indices in range."""
        out = torch.zeros_like(valid)
        for s in range(count):
            idx = starts + s
            in_range = (idx >= 0) & (idx < nz)
            out = out | (_take(values, idx) & in_range & valid)
        return out

    def _set_at(a, i, where, value):
        """a (B, nz) with a[b, i[b, z]] = value wherever ``where[b, z]``."""
        padded = torch.cat([a, torch.zeros_like(a[:, :1])], dim=1)
        idx = torch.where(where, torch.clamp(i, 0, nz), nz)
        return padded.scatter(1, idx, torch.full_like(padded, value))[:, :nz]

    def apply_mask_limiter(save, candidate, difference, no_conv_to_rad, lr_intended):
        if shift < 0:
            return candidate
        if shift == 0:
            return save
        result = save
        _, lo_z, hi_z, valid_z = _runs(save)

        # grow downward: candidate[lo] and the full window below in range
        grow_dn = (valid_z & _take(candidate, lo_z) & (lo_z - shift >= 0)
                   & _window_any(candidate, lo_z - shift, shift, valid_z))
        # grow upward
        grow_up = (valid_z & _take(candidate, hi_z) & (hi_z + shift < nz)
                   & _window_any(candidate, hi_z + 1, shift, valid_z))
        # shrink (only when allowed and the zone is longer than the shift)
        zone_len = hi_z - lo_z + 1
        can_shrink = valid_z & (not no_conv_to_rad) & (shift < zone_len)
        shrink_lo = can_shrink & ~_window_any(candidate, lo_z, shift, valid_z)
        shrink_hi = can_shrink & ~_window_any(candidate, hi_z - shift + 1, shift, valid_z)
        for s in range(shift):
            result = _set_at(result, lo_z - 1 - s, grow_dn, True)
            result = _set_at(result, hi_z + 1 + s, grow_up, True)
            result = _set_at(result, lo_z + s, shrink_lo, False)
            result = _set_at(result, hi_z - s, shrink_hi, False)

        # new convective islands need strong instability (solve.f90:1180-1207)
        isl = candidate & ~save
        zid_i, lo_i, _, valid_i = _runs(isl)
        thresh = torch.clamp(hyst_on * _zone_max(torch.abs(lr_intended), zid_i), min=hyst_min)
        island_ok = valid_i & (_zone_max(difference, zid_i) > thresh)
        lo_of_row = torch.gather(torch.cat([lo_i, torch.zeros_like(lo_i[:, :1])], dim=1), 1,
                                 zid_i)
        ok_of_row = torch.gather(torch.cat([island_ok, torch.zeros_like(island_ok[:, :1])],
                                           dim=1), 1, zid_i)
        row_on = isl & ok_of_row & (idx_layers - lo_of_row < 2 * shift)
        return result | row_on

    # ------------------------------------------------------------------
    # mask updates (solve.f90:899-1112)
    # ------------------------------------------------------------------

    def _thresholds(lr_intended):
        on = torch.clamp(hyst_on * torch.abs(lr_intended), min=hyst_min)
        off = torch.clamp(hyst_off * torch.abs(lr_intended), min=hyst_min)
        return on, off

    def mode1_update(x_model, save, lock, P_i_surf, lanes=None):
        """Trial-Newton-step classification on the all-radiative system.
        ``lanes`` (B,) bool: the lanes whose result is used (all when None);
        the backtracking stops once each of them has a valid trial."""
        zeros = torch.zeros_like(save)
        xm, dFdt, dTdt, aux = objective(x_model, zeros, P_i_surf)
        J = jacobian(xm, zeros, aux, dTdt)
        deltaT = _linsolve(J, -dTdt)
        alpha = torch.full_like(dFdt[:, 0], min(max(0.0, newton_step_size), 1.0))
        lr_pert = torch.zeros_like(aux["lr_intended"])
        got = torch.zeros_like(save[:, 0])
        tries = 0
        wanted = torch.ones_like(got) if lanes is None else lanes
        while tries < 20:
            b_active = wanted & ~got
            if not bool(b_active.any()):
                break
            T_pert = xm + alpha[:, None] * deltaT
            prof_t = rebuild(T_pert, zeros, P_i_surf)
            ok = ((torch.amin(T_pert, dim=-1) >= 1.0)
                  & torch.isfinite(prof_t["x_model"]).all(dim=-1)
                  & torch.isfinite(prof_t["lr_actual"]).all(dim=-1))
            alpha = torch.where(b_active & ~ok, alpha * 0.5, alpha)
            lr_pert = _where(b_active & ok, prof_t["lr_actual"], lr_pert)
            got = got | (b_active & ok)
            tries += 1
        difference = lr_pert - aux["lr_intended"]
        on, off = _thresholds(aux["lr_intended"])
        candidate = torch.where(save, ~(difference < -off), difference > on)
        new_mask = apply_mask_limiter(save, candidate, difference, False, aux["lr_intended"])
        # if the backtracking never found a valid trial profile the
        # classification is meaningless: keep the old mask
        return _where(got, new_mask, save), lock

    def mode2_update(x_model, save, lock, P_i_surf, lanes=None):
        """Promotion-only classification from the converged state."""
        prof = rebuild(x_model, save, P_i_surf)
        difference = prof["lr_actual"] - prof["lr_intended"]
        on, _ = _thresholds(prof["lr_intended"])
        candidate = save | ((~save) & (difference > on))
        return apply_mask_limiter(save, candidate, difference, True, prof["lr_intended"]), lock

    def mode3_update(x_model, save, lock, P_i_surf, lanes=None):
        """prevent_overconvection polish with per-layer lockouts."""
        prof = rebuild(x_model, save, P_i_surf)
        difference = prof["lr_actual"] - prof["lr_intended"]
        lr_actual = prof["lr_actual"]
        on, off = _thresholds(prof["lr_intended"])
        lock = torch.clamp(lock - 1, min=0)

        def one_pass(conv, lock, allow_retract):
            _, _, hi_z, valid_z = _runs(conv)
            jj = hi_z + 1  # layer above each zone top
            ok_z = valid_z & (hi_z < nz - 1)
            extend = ok_z & (_take(difference, jj) > _take(on, jj))
            retract = (ok_z & allow_retract & ~extend
                       & (_take(lr_actual, jj) < -_take(off, jj)) & (_take(lock, hi_z) == 0))
            conv = _set_at(conv, jj, extend, True)
            conv = _set_at(conv, hi_z, retract, False)
            lock = _set_at(lock, jj, extend, 2)
            return conv, lock

        # the host scan cascades zone-top extensions within one call; the
        # retraction branch fires at most once per zone: one extend+retract
        # pass, then extend-only passes to a fixed point (at most nz)
        conv, lock = one_pass(save, lock, True)
        changed = torch.ones_like(conv[:, 0]) if lanes is None else lanes.clone()
        for _ in range(nz):
            if not bool(changed.any()):
                break
            conv2, lock2 = one_pass(conv, lock, False)
            conv2 = _where(changed, conv2, conv)
            lock = _where(changed, lock2, lock)
            changed = changed & (conv2 != conv).any(dim=-1)
            conv = conv2
        return conv, lock

    updates = (mode1_update, mode2_update, mode3_update)

    def update_mask(mode, x_model, conv, lock, P_i_surf, lanes=None):
        """The mask update of each lane's mode (B,), 1-3; only the modes of
        the lanes ``lanes`` (all when None) are evaluated."""
        branch = torch.clamp(mode - 1, 0, 2)
        wanted = torch.ones_like(conv[:, 0]) if lanes is None else lanes
        new_conv, new_lock = conv, lock
        for b, fn in enumerate(updates):
            sel = wanted & (branch == b)
            if bool(sel.any()):
                conv_b, lock_b = fn(x_model, conv, lock, P_i_surf, sel)
                new_conv = _where(sel, conv_b, new_conv)
                new_lock = _where(sel, lock_b, new_lock)
        return new_conv, new_lock

    # ------------------------------------------------------------------
    # RCE outer loop (solve.f90:173-377)
    # ------------------------------------------------------------------

    def rce(x0, conv0, use_guess, P_i_surf):
        """Full RCE for a batch of columns.

        x0 (B, nz+1) [T_surf_guess, T_guess]; conv0 (B, nz) initial masks
        (used where ``use_guess`` (B,)); P_i_surf (B, ng).
        """
        B = x0.shape[0]
        lock0 = torch.zeros((B, nz), dtype=torch.int64, device=dev)
        conv_start = conv0
        if not bool(use_guess.all()):
            conv_init, _ = mode1_update(x0, torch.zeros_like(conv0), lock0, P_i_surf,
                                        ~use_guess)
            conv_start = _where(use_guess, conv0, conv_init)
        izero = torch.zeros(B, dtype=torch.int64, device=dev)
        st = dict(
            x=x0, conv=conv_start, mode=izero + (1 if max_rc_iters_convection > 1 else 2),
            perform_solve=torch.ones_like(use_guess), lock=lock0, it=izero,
            converged=torch.zeros_like(use_guess), ok=torch.ones_like(use_guess),
            mask_solved=conv_start, solve_iters=izero,
            diag=dict(ratio_best=torch.full((B,), torch.inf, dtype=x0.dtype, device=dev),
                      it_total=izero, out_of_stages=torch.zeros_like(use_guess)),
        )
        if record_trace:
            # per-outer-iteration max|F/F0| trajectory (one extra objective
            # per iteration; off by default)
            st["ratio_trace"] = torch.full((B, max(max_rc_iters, 0)), torch.nan,
                                           dtype=torch.float64, device=dev)
        done = torch.full((B,), max_rc_iters < 1, device=dev)

        while bool((~done).any()):
            active = ~done
            solving = active & st["perform_solve"]
            x_s, solve_ok = st["x"], torch.ones_like(active)
            its, diag = izero, st["diag"]
            if bool(solving.any()):
                x_sol, ok_sol, its_sol, diag_sol = solve_strategy(st["x"], st["conv"],
                                                                  P_i_surf, solving)
                x_s = _where(solving, x_sol, x_s)
                solve_ok = torch.where(solving, ok_sol, solve_ok)
                its = torch.where(solving, its_sol, its)
                diag = _where(solving, diag_sol, diag)
            mask_solved = _where(st["perform_solve"], st["conv"], st["mask_solved"])
            save = st["conv"]
            conv2, lock2 = update_mask(st["mode"], x_s, save, st["lock"], P_i_surf, active)
            changed = (conv2 != save).any(dim=-1)

            mode = st["mode"]
            it = st["it"] + 1
            # transitions (solve.f90:305-362)
            to_mode2 = (mode == 1) & (
                (~changed & require_mode2)
                | (changed & (it >= max_rc_iters_convection - 1)))
            to_mode3 = (((mode == 1) & ~changed & (not require_mode2) & prevent_overconvection)
                        | ((mode == 2) & ~changed & prevent_overconvection))
            conv_now = (
                ((mode == 1) & ~changed & (not require_mode2) & (not prevent_overconvection))
                | ((mode == 2) & ~changed & (not prevent_overconvection))
                | ((mode == 3) & ~changed))
            skip_solve = ~changed & (to_mode2 | to_mode3)
            mode_new = torch.where(to_mode2, 2, torch.where(to_mode3, 3, mode))
            if verbose:
                _verbose_outer_line(it, mode, changed, solve_ok, its)
            new = dict(
                x=x_s, conv=conv2, mode=mode_new, perform_solve=~skip_solve, lock=lock2,
                it=it, converged=conv_now, ok=st["ok"] & solve_ok, mask_solved=mask_solved,
                solve_iters=st["solve_iters"] + its, diag=diag,
            )
            if record_trace:
                _, dFdt_tr, _, _ = objective(x_s, save, P_i_surf)
                trace = st["ratio_trace"].clone()
                rows = torch.arange(B, device=dev)
                cols = torch.clamp(st["it"], max=trace.shape[1] - 1)
                trace[rows, cols] = flux_ratio(dFdt_tr).to(trace.dtype)
                new["ratio_trace"] = trace
            st = _where(active, new, st)
            done = done | (active & (conv_now | ~solve_ok | (it >= max_rc_iters)))

        # Final state on the mask used for the last solve, evaluated together
        # with the precision-floor probe as one objective over 2B lanes: the
        # residual at a 4-ulp temperature perturbation, far below any
        # physical signal, so the change in max|F/F0| is the arithmetic noise
        # of the flux path at this state.
        eps_x = 4.0 * torch.finfo(st["x"].dtype).eps
        mask2 = torch.cat([st["mask_solved"], st["mask_solved"]])
        xm2, dFdt2, _, aux2 = objective(torch.cat([st["x"], st["x"] * (1.0 + eps_x)]), mask2,
                                        torch.cat([P_i_surf, P_i_surf]))
        first = slice(0, B)
        xm, dFdt, aux = xm2[first], dFdt2[first], _lanes(aux2, first)
        converged = st["converged"] & st["ok"]
        ratio_final = flux_ratio(dFdt)
        ratio_floor = torch.abs(flux_ratio(dFdt2[B:]) - ratio_final)
        # failure classification: a best-iterate return with converged=False
        # can be far off aloft while T_surf looks plausible. status:
        #   0 converged
        #   1 iteration cap reached NEAR the tolerance (ratio_best < 10*xtol)
        #   2 stalled at the precision floor: the best residual within 10x of
        #     the measured arithmetic noise (ratio_floor), or the last solve
        #     exhausted every strategy stage without meeting the tolerance
        #   3 other (budget spent while still improving / diverged)
        d = st["diag"]
        near_tol = d["ratio_best"] < 10.0 * xtol_rc
        at_floor = d["out_of_stages"] | (d["ratio_best"] < 10.0 * ratio_floor)
        status = torch.where(converged, 0, torch.where(near_tol, 1, torch.where(at_floor, 2, 3)))
        res = dict(
            T_surf=xm[:, 0], T=xm[:, 1:],
            convecting_with_below=st["mask_solved"],
            converged=converged,
            status=status,
            solve_diag=d,  # raw classifier inputs from the last solve
            ratio_best=d["ratio_best"],
            # measured arithmetic-noise level of the convergence ratio at the
            # returned state (the precision floor estimate)
            ratio_floor=ratio_floor,
            # per-row flux residual (mW/m^2) at the returned state
            residual_dFdt=dFdt,
            rc_iters=st["it"], solve_iters=st["solve_iters"],
            max_ratio=ratio_final,
            P=aux["P_c"], f_i=aux["f_c"], dz=aux["dz"], z=aux["z"],
            P_surf=aux["P_surf"], N_surface=aux["N_surface"],
            f_total=aux["f_total"],
        )
        if record_trace:
            res["ratio_trace"] = st["ratio_trace"]
        return res

    return dict(
        rce=rce,
        objective=objective,
        jacobian=jacobian,
        residuals=residuals,
        rebuild=rebuild,
        solve_strategy=solve_strategy,
        update_mask=update_mask,
        apply_mask_limiter=apply_mask_limiter,
    )


def batched_rce(c, P_i_surf_b, T_surf_guess_b, T_guess_b,
                convecting_with_below_b=None, mesh=None,
                chunk_iters=None, max_chunks=50, _cache=None,
                **build_kwargs):
    """Batched RCE over a column ensemble on ``c.device``.

    Every column runs the full reference RCE loop (profile rebuild, RT,
    Newton/PTC stages, mask updates); each step evaluates every column in
    one batched call. Columns never interact. Sharding over a device mesh is
    not ported: ``mesh`` must be None.

    Returns a dict of (B, ...) tensors (T_surf, T, convecting_with_below,
    converged, status, ratio_best, residual_dFdt, max_ratio, rc_iters, P,
    f_i, ...).

    ``chunk_iters`` bounds the inner-solver iterations of one pass: the full
    solve becomes up to ``max_chunks`` passes, each warm-restarted from the
    previous one's state (T and convection mask back in as the guess), with
    host-side progress between them; a resumed solve restarts its Newton seed
    ladder/PTC clock from the best state, which does not change the fixed
    point. ``rc_iters``/``solve_iters`` accumulate across chunks; other
    diagnostics are the last chunk's.

    ``_cache``: a caller-owned dict that keeps the built functions across
    calls with identical build arguments (the RC march's interval graphs are
    kept on the model, per batch size).

    .. warning:: When ``converged[b]`` is False the returned column is the
       BEST ITERATE, not an equilibrium. ``status[b]`` says how it failed:
       1 = iteration cap near tolerance (ratio_best < 10*xtol_rc), 2 =
       stalled at the precision floor (ratio_best within 10x of
       ``ratio_floor``, the measured arithmetic noise of the flux residual
       at the returned state, or every solver stage exhausted), 3 = other.
       ``residual_dFdt[b]`` is the per-row flux residual of the returned
       state (mW/m^2).
    """
    _no_mesh(mesh)
    if chunk_iters is not None:
        build_kwargs = dict(build_kwargs, max_total_iters=int(chunk_iters))
    key = repr(sorted(build_kwargs.items()))
    if _cache is not None and _cache.get("key") == key:
        fns = _cache["fns"]
    else:
        fns = build_rce_fns(c, **build_kwargs)
        if _cache is not None:
            _cache["key"] = key
            _cache["fns"] = fns
    t = c._tensor
    P_i_surf_b = t(P_i_surf_b)
    B = P_i_surf_b.shape[0]
    T_surf_guess_b = torch.broadcast_to(t(T_surf_guess_b), (B,))
    x0_b = torch.cat([T_surf_guess_b[:, None], t(T_guess_b)], dim=1)
    if convecting_with_below_b is None:
        conv0_b = torch.zeros((B, c.nz), dtype=torch.bool, device=c.device)
        use_guess_b = torch.zeros(B, dtype=torch.bool, device=c.device)
    else:
        conv0_b = torch.as_tensor(np.asarray(convecting_with_below_b, bool), device=c.device)
        use_guess_b = torch.ones(B, dtype=torch.bool, device=c.device)
    if chunk_iters is None:
        return fns["rce"](x0_b, conv0_b, use_guess_b, P_i_surf_b)

    rc_acc = np.zeros(B, np.int64)
    sv_acc = np.zeros(B, np.int64)
    prev_best = np.full(B, np.inf)
    stalls = 0
    out = None
    for _ in range(max_chunks):
        out = fns["rce"](x0_b, conv0_b, use_guess_b, P_i_surf_b)
        conv_h = out["converged"].cpu().numpy()
        rc_acc += out["rc_iters"].cpu().numpy()
        sv_acc += out["solve_iters"].cpu().numpy()
        best = out["ratio_best"].cpu().numpy().astype(np.float64)
        if conv_h.all():
            break
        # stop only after TWO consecutive chunks in which no unconverged
        # lane improved (e.g. all stalled at the precision floor): a single
        # flat chunk can just be a Newton attempt that needs its seed
        # ladder, which the next warm restart re-enters
        improving = (~conv_h) & (best < 0.99 * prev_best)
        stalls = 0 if improving.any() or not np.isfinite(prev_best).all() else stalls + 1
        if stalls >= 2:
            break
        prev_best = np.minimum(prev_best, best)
        x0_b = torch.cat([out["T_surf"][:, None], out["T"]], dim=1)
        conv0_b = out["convecting_with_below"]
        use_guess_b = torch.ones(B, dtype=torch.bool, device=c.device)
    out = dict(out)
    out["rc_iters"] = torch.as_tensor(rc_acc, device=c.device)
    out["solve_iters"] = torch.as_tensor(sv_acc, device=c.device)
    return out
