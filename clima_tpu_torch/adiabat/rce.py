"""Radiative-convective equilibrium solver.

Port of the JAX package's ``clima_tpu/adiabat/rce.py``, which re-implements
``src/adiabat/clima_adiabat_solve.f90``: the RCE outer loop alternates (a) a
nonlinear solve of the energy balance on the current convection mask (HYBRJ
and/or PTC per ``rce_solve_strategy``) with (b) convection-mask updates
(modes 1/2/3 with hysteresis and boundary limiting), until the mask stops
changing.

The unknowns are the surface + radiative-layer + convective-zone-bottom
temperatures (``inds_Tx``, solve.f90:868-877). The profile rebuild
(:func:`.profile_rc.make_profile_rc_core`) and the radiative transfer run on
the model's device; on the card the RC march replays one interval's CUDA
graph, captured once per model and shape (``AdiabatClimate._rc_graphs``), so
a new mask or temperature profile recaptures nothing. The zone bookkeeping,
the finite-difference Jacobian assembly, the mask updates and the HYBRJ/PTC
solvers are host numpy (O(nz)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as const
from ..config.species import heat_capacity
from ..solvers.newton import ConvergedEarly, hybrj
from ..solvers.ptc import PTC_CONVERGED_USER, PTCSolver
from ..utils.errors import ClimaException
from .adiabat import (
    RCE_SOLVE_HYBRJ_ONLY,
    RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ,
    RCE_SOLVE_PTC_THEN_HYBRJ,
    AdiabatClimate,
)
from .profile_rc import CustomMix, make_profile_rc_core

__all__ = []


def _custom_mix(self):
    """The custom prescribed-mix species as tensors on the model's device."""
    ng = self.sp.ng
    if self._mix_custom_grid is None:
        log10P, log10mix, mask = np.array([-400.0, 400.0]), np.zeros((2, ng)), np.zeros(ng, bool)
    else:
        (log10P, log10mix), mask = self._mix_custom_grid, self.sp_custom
    return CustomMix(self._tensor(log10P), self._tensor(log10mix),
                     torch.as_tensor(np.asarray(mask), device=self.device))


def _initialize_custom_inputs(self, sp_custom, P_custom, mix_custom):
    """Custom prescribed-mix species (solve.f90:92-171)."""
    ng = self.sp.ng
    if sp_custom is None and P_custom is None and mix_custom is None:
        self.sp_custom = np.zeros(ng, dtype=bool)
        self._mix_custom_grid = None
        return
    if sp_custom is None or P_custom is None or mix_custom is None:
        raise ClimaException(
            "`sp_custom`, `P_custom` and `mix_custom` must all be given together"
        )
    P_custom = np.asarray(P_custom, dtype=np.float64)
    mix_custom = np.asarray(mix_custom, dtype=np.float64)
    if len(sp_custom) != mix_custom.shape[1]:
        raise ClimaException("`sp_custom` and `mix_custom` have incompatible shapes")
    if len(P_custom) != mix_custom.shape[0]:
        raise ClimaException("`P_custom` and `mix_custom` have incompatible shapes")
    if np.any(mix_custom < 0):
        raise ClimaException("`mix_custom` can not have negative values")
    if np.any(P_custom <= 0):
        raise ClimaException("`P_custom` must be > 0 for all values")

    mix_norm = mix_custom / np.sum(mix_custom, axis=1, keepdims=True)
    tiny, big = 2.2250738585072014e-308, 1.0e300
    grid = np.log10(np.concatenate([[tiny], P_custom[::-1], [big]]))
    log10mix = np.zeros((len(grid), ng))
    mask = np.zeros(ng, dtype=bool)
    for isp, name in enumerate(sp_custom):
        if name not in self.species_names:
            raise ClimaException(f'Custom species "{name}" is not in the list of species')
        ind = self.species_names.index(name)
        mask[ind] = True
        col = mix_norm[:, isp]
        padded = np.concatenate([[col[-1]], col[::-1], [col[0]]])
        log10mix[:, ind] = np.log10(np.maximum(padded, tiny))
    self.sp_custom = mask
    self._mix_custom_grid = (grid, log10mix)


def make_profile_rc(self, P_i_surf, T_in):
    """Rebuild the column for the current convection mask (solve.f90:7-89)."""
    P_i_surf = np.asarray(P_i_surf, dtype=np.float64)
    T_in = np.asarray(T_in, dtype=np.float64)
    if P_i_surf.shape != (self.sp.ng,):
        raise ClimaException("P_i_surf has the wrong dimension")
    if T_in.shape != (self.nz + 1,):
        raise ClimaException("T_in has the wrong dimension")
    _check_temperature_range(self, T_in)

    out = make_profile_rc_core(
        dataclasses.replace(self._par, P_top=float(self.P_top)), self._tensor(self.RH),
        self._tensor(T_in[0]), self._tensor(T_in[1:]), self._tensor(P_i_surf),
        torch.as_tensor(self.convecting_with_below, device=self.device), _custom_mix(self),
        graphs=self._rc_graphs,
    )
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    if not np.isfinite(out["T"]).all():
        raise ClimaException("make_profile_rc produced non-finite temperatures")

    P_e, f_i_e = out["P_e"], out["f_i_e"]
    self.T_surf = float(T_in[0])
    self.T = out["T"].copy()
    self.P_surf = float(out["P_surf"])
    self.P = P_e[1::2].copy()
    self.f_i_surf = f_i_e[0].copy()
    self.f_i = f_i_e[1::2].copy()
    self.N_surface = out["N_surface"].copy()
    self.P_trop = -1.0

    self.compute_altitude()
    density = self.P / (const.k_boltz * self.T)
    self.densities = self.f_i * density[:, None]
    self.interpolate_particles(self.P)
    self.N_atmos = np.sum(density[:, None] * self.f_i * self.dz[:, None], axis=0) / const.N_avo

    lr_e = out["lapse_rate_e"]
    self.lapse_rate_intended = np.concatenate([[lr_e[0]], lr_e[1:-1:2][: self.nz - 1]])
    self._set_lapse_rates()
    self.super_saturated = np.zeros(self.nz, dtype=bool)

    # oceans (bookkeeping only; does not affect the profile)
    self._ocean_reservoirs(self.T_surf, self.f_i_surf * self.P_surf)


# ----------------------------------------------------------------------------
# zone bookkeeping (solve.f90:824-890)
# ----------------------------------------------------------------------------


def _set_convecting_zones(self, convecting_with_below):
    conv = np.asarray(convecting_with_below, dtype=bool)
    if conv.shape != (self.nz,):
        raise ClimaException('Input "convecting_with_below" has the wrong dimension')
    self.convecting_with_below = conv.copy()

    lowers, uppers = [], []
    i = 0
    while i < self.nz:
        if conv[i]:
            lowers.append(i + 1)  # 1-based (1 = ground link)
            j = i
            while j < self.nz and conv[j]:
                j += 1
            uppers.append(j + 1)
            i = j
        else:
            i += 1
    self.n_convecting_zones = len(lowers)
    self._ind_conv_lower = np.array(lowers, dtype=int)
    self._ind_conv_upper = np.array(uppers, dtype=int)

    # DOF indices into the (nz+1) temperature vector (1-based; 1 = surface)
    self._inds_Tx = np.array([1] + [i + 2 for i in range(self.nz) if not conv[i]], dtype=int)

    lower_x = []
    for lo in lowers:
        pos = np.where(self._inds_Tx == lo)[0]
        if len(pos) == 0:
            raise ClimaException("Problem setting a convective zone")
        lower_x.append(pos[0])
    self._ind_conv_lower_x = np.array(lower_x, dtype=int)


# ----------------------------------------------------------------------------
# objective & residuals (solve.f90:648-739, 1212-1327)
# ----------------------------------------------------------------------------


def _residuals_with_convection(self, f_total):
    """Residuals in erg/(cm^2 s) and K/s for each active DOF."""
    nz = self.nz
    fluxes = np.empty(nz + 1)
    fluxes[0] = f_total[0]
    fluxes[1:] = f_total[1:] - f_total[:-1]

    mubar = self.f_i @ self.sp.gas_masses
    density = self.P / (const.k_boltz * self.T)
    rho = density * (1.0 / const.N_avo) * mubar
    cp_i = heat_capacity(self.sp.thermo, torch.as_tensor(self.T)).numpy()
    cp = np.sum(cp_i * self.f_i, axis=1)
    cp = cp * (1.0 / (mubar * 1.0e-3)) * 1.0e4  # erg/(g K)

    n_active = len(self._inds_Tx)
    dFdt = np.array([fluxes[ind - 1] for ind in self._inds_Tx])

    for zi in range(self.n_convecting_zones):
        lo = self._ind_conv_lower[zi]
        up = self._ind_conv_upper[zi]
        f_lower = 0.0 if lo == 1 else f_total[lo - 2]
        f_upper = f_total[up - 1] + (self.surface_heat_flow if lo == 1 else 0.0)
        dFdt[self._ind_conv_lower_x[zi]] = f_upper - f_lower

    c_surface = rho[0] * cp[0] * self.dz[0]
    dTdt = np.empty(n_active)
    for i in range(n_active):
        zi = np.where(self._ind_conv_lower_x == i)[0]
        if len(zi) > 0:
            lo = self._ind_conv_lower[zi[0]]
            up = self._ind_conv_upper[zi[0]]
            k_lo = max(1, lo - 1)
            k_up = up - 1
            c_eff = np.sum(rho[k_lo - 1 : k_up] * cp[k_lo - 1 : k_up] * self.dz[k_lo - 1 : k_up])
            if lo == 1:
                c_eff += c_surface
        elif self._inds_Tx[i] == 1:
            c_eff = c_surface
        else:
            j = self._inds_Tx[i] - 2
            c_eff = rho[j] * cp[j] * self.dz[j]
        dTdt[i] = dFdt[i] / max(c_eff, 1e-300)
    return dFdt, dTdt


def _check_temperature_range(self, T_in, lo=0.5, hi=6000.0):
    """Reject unphysical temperatures with an error, like the reference.

    The reference's heat_capacity_eval errors for T outside the thermo
    tables' ranges (clima_eqns.f90:105-133), which keeps HYBRJ/PTC trial
    steps inside physical territory; the guard is explicit here, as in the
    JAX package. A convective-layer placeholder of -1 is allowed (filled in
    by the adiabat integration).
    """
    T = np.asarray(T_in)
    bad = ~(((T > lo) & (T < hi)) | (T == -1.0))
    if np.any(bad):
        raise ClimaException(
            f"temperature out of physical range [{lo}, {hi}]: "
            f"min={np.min(T):.3g}, max={np.max(T):.3g}"
        )


def _objective_fixed_profile(self, T_in, compute_solar, compute_opacity):
    """Radiate at temperatures T_in on the frozen profile (solve.f90:679-739)."""
    _check_temperature_range(self, T_in)
    self.T_surf = float(T_in[0])
    self.T = np.asarray(T_in[1:], dtype=np.float64).copy()
    density = self.P / (const.k_boltz * self.T)
    self.densities = self.f_i * density[:, None]
    self._set_lapse_rates()

    T_r, P_r, dens_r, dz_r, pdens_r, prad_r = self.copy_atm_to_radiative_grid()
    self.rad.radiate(
        self.T_surf, T_r, P_r / 1.0e6, dens_r, dz_r, pdens_r, prad_r,
        compute_solar=compute_solar, compute_opacity=compute_opacity,
    )

    if self.tidally_locked_dayside and compute_solar:
        _, _, f_term = self.heat_redistribution_parameters()
        self.rad.apply_radiation_enhancement(4.0 * f_term)

    f_total = _f_total_edges_precise(self)
    f_total[0] += self.surface_heat_flow
    return _residuals_with_convection(self, f_total)


def _f_total_edges_precise(self):
    """Net flux at the physical-layer edges, cancellation-safe.

    The energy-balance residual differences net fluxes (~1 mW/m^2) that are
    tiny compared to the fluxes themselves (~1e5 mW/m^2). Rebuilding the edge
    profile from the PER-BIN arrays (adjacent-edge differences of nearby
    values are exact, Sterbenz) and accumulating the frequency integral and
    the cumulative sum in float64 keeps the residual's precision at any
    compute dtype.
    """
    e = slice(0, 2 * self.nz + 1, 2)  # physical edges on the doubled grid

    def net_parts(w, freq):
        net_a = (w.fdn_a - w.fup_a)[e, :]
        dfreq = (freq[:-1] - freq[1:]).astype(np.float64)
        base = np.sum(net_a[0].astype(np.float64) * dfreq)
        d = np.sum(np.diff(net_a, axis=0).astype(np.float64) * dfreq, axis=1)
        return base, d

    b_ir, d_ir = net_parts(self.rad.wrk_ir, self.rad.ir.freq)
    b_sol, d_sol = net_parts(self.rad.wrk_sol, self.rad.sol.freq)
    f_total = np.empty(self.nz + 1)
    f_total[0] = b_ir + b_sol
    f_total[1:] = f_total[0] + np.cumsum(d_ir + d_sol)
    return f_total


def _objective(self, P_i_surf, x):
    """Full objective: rebuild profile at DOF temps, radiate, residuals."""
    T_in = np.concatenate([[self.T_surf], self.T])
    for i, ind in enumerate(self._inds_Tx):
        T_in[ind - 1] = x[i]
    make_profile_rc(self, P_i_surf, T_in)
    T_in[0] = self.T_surf
    T_in[1:] = self.T
    return _objective_fixed_profile(self, T_in, True, True)


def _perturbation_matrix(self, x):
    """The FD perturbation temperature matrix (n, nz+1) with zone blocks."""
    n = len(x)
    T_base = np.concatenate([[self.T_surf], self.T])
    T_perts = np.repeat(T_base[None, :], n, axis=0)
    deltas = np.empty(n)
    for i in range(n):
        deltaT = self.epsj * abs(x[i])
        deltas[i] = deltaT
        T_perts[i, self._inds_Tx[i] - 1] += deltaT
        zi = np.where(self._ind_conv_lower_x == i)[0]
        if len(zi) > 0:
            lo = self._ind_conv_lower[zi[0]]
            up = self._ind_conv_upper[zi[0]]
            T_perts[i, lo - 1 : up] = T_base[lo - 1 : up] + deltaT
    return T_base, T_perts, deltas


def _radiative_grid(T):
    """Layer temperatures (n, nz) on the doubled radiative grid with its two
    ghost layers (n, 2 nz + 2), as copy_atm_to_radiative_grid lays them out."""
    return np.concatenate([np.repeat(T, 2, axis=1), T[:, -1:], T[:, -1:]], axis=1)


def _jacobian_from_base(self, x, dTdt_base):
    """FD Jacobian with zone-block perturbation (solve.f90:768-822).

    Opacity is NOT recomputed and solar RT follows ``compute_solar_in_jac``,
    the reference's cost/conditioning choices, so (in the default
    configuration) each perturbed column differs ONLY in the IR Planck
    source. All n perturbations therefore run as ONE batched IR call
    (:meth:`..radtran.Radtran.ir_fluxes_batch`, n columns through the IR
    two-stream kernel) instead of n serial RT evaluations (the reference's
    serial FD loop), with the O(nz) residual assembly on the host.
    """
    T_base, T_perts, deltas = _perturbation_matrix(self, x)
    n = len(x)

    if self.compute_solar_in_jac or self.tidally_locked_dayside:
        # general path: serial fixed-profile objectives (rare configuration)
        jac = np.empty((n, n))
        for i in range(n):
            _, dTdt_p = _objective_fixed_profile(self, T_perts[i], self.compute_solar_in_jac,
                                                 False)
            jac[:, i] = (dTdt_p - dTdt_base) / deltas[i]
        _objective_fixed_profile(self, T_base, self.compute_solar_in_jac, False)
        return jac

    # batched path: one IR call over all perturbations
    rad = self.rad
    fup_n, fdn_n = rad.ir_fluxes_batch(T_perts[:, 0], _radiative_grid(T_perts[:, 1:]))
    ir_net = (fdn_n - fup_n).cpu().numpy()

    # frozen solar contribution to the net flux
    sol_net = rad.wrk_sol.fdn_n - rad.wrk_sol.fup_n

    jac = np.empty((n, n))
    T_save, T_surf_save, dens_save = self.T.copy(), self.T_surf, self.densities.copy()
    for i in range(n):
        f_total = (sol_net + ir_net[i])[0::2][: self.nz + 1].copy()
        f_total[0] += self.surface_heat_flow
        # residual assembly uses layer T for rho/cp: set perturbed temps
        self.T_surf = float(T_perts[i, 0])
        self.T = T_perts[i, 1:].copy()
        _, dTdt_p = _residuals_with_convection(self, f_total)
        jac[:, i] = (dTdt_p - dTdt_base) / deltas[i]
    self.T_surf, self.T, self.densities = T_surf_save, T_save, dens_save
    return jac


def _flux_metrics(self, dFdt):
    """max|F| (W/m^2) and max|F/F0| (solve.f90:620-634)."""
    char = abs(self.rad.bolometric_flux() / 4.0 + self.surface_heat_flow * 1.0e-3)
    char = max(char, 1.0e-6)
    max_f = np.max(np.abs(dFdt)) * 1.0e-3
    return max_f, max_f / char


# ----------------------------------------------------------------------------
# nonlinear solves (solve.f90:379-618)
# ----------------------------------------------------------------------------


def _run_hybrj(self, P_i_surf, x_seed):
    """HYBRJ with custom flux convergence and perturbed-seed retries."""
    state = {"dFdt": None, "dTdt_base": None, "x_base": None}

    def fcn(x):
        dFdt, dTdt = _objective(self, P_i_surf, x)
        state.update(dFdt=dFdt, dTdt_base=dTdt, x_base=x.copy())
        max_f, max_ratio = _flux_metrics(self, dFdt)
        if self.verbose:
            print(f"   max|F| = {max_f:9.2e}   max|F/F0| = {max_ratio:9.2e}   "
                  f"max(T) = {np.max(x):7.1f}   min(T) = {np.min(x):7.1f}")
        if max_ratio < self.xtol_rc:
            raise ConvergedEarly(x, dTdt)
        return dTdt

    def jac(x):
        if state["x_base"] is None or not np.array_equal(x, state["x_base"]):
            dFdt, dTdt = _objective(self, P_i_surf, x)
            state.update(dFdt=dFdt, dTdt_base=dTdt, x_base=x.copy())
        return _jacobian_from_base(self, x, state["dTdt_base"])

    for k in range(4):
        pert = float(k) * (1.0 if k % 2 == 0 else -1.0)
        if self.verbose and k > 0:
            print(f"   Perturbation = {pert:7.1f}")
        try:
            x, fvec, info = hybrj(fcn, jac, x_seed + pert, xtol=1.0e-12, maxfev=100)
        except ClimaException:
            info = 0
            x, fvec = x_seed, None
        if info == 1 and state["dFdt"] is not None:
            _, max_ratio = _flux_metrics(self, state["dFdt"])
            if max_ratio < self.xtol_rc:
                return x, fvec, state["dFdt"], True
    return x, fvec, state["dFdt"], False


def _run_ptc(self, P_i_surf, x_seed):
    state = {"dFdt": None, "dTdt_base": None, "x_base": None}

    def f(x):
        dFdt, dTdt = _objective(self, P_i_surf, x)
        state.update(dFdt=dFdt, dTdt_base=dTdt, x_base=x.copy())
        return dTdt

    def jac(x):
        if state["x_base"] is None or not np.array_equal(x, state["x_base"]):
            f(x)
        return _jacobian_from_base(self, x, state["dTdt_base"])

    def converged(solver):
        if state["dFdt"] is None:
            return False
        _, max_ratio = _flux_metrics(self, state["dFdt"])
        return max_ratio < self.xtol_rc

    def progress(solver):
        if self.verbose:
            max_f, max_ratio = _flux_metrics(self, state["dFdt"])
            print(f"   step = {solver.steps:4d}   dt = {solver.dt:10.3e}   "
                  f"max|F| = {max_f:9.2e}   max|F/F0| = {max_ratio:9.2e}")

    solver = PTCSolver(
        x_seed, f, jac, dt=None, dt_increment=self.dt_increment, max_steps=300,
        custom_convergence=converged, progress=progress,
    )
    try:
        reason = solver.solve()
    except ClimaException:
        return x_seed, None, state["dFdt"], False
    return solver.x, solver.fvec, state["dFdt"], reason == PTC_CONVERGED_USER


# ----------------------------------------------------------------------------
# convection-mask updates (solve.f90:899-1210)
# ----------------------------------------------------------------------------


def _apply_mask_limiter(self, save, candidate, difference, no_conv_to_rad):
    """Boundary-motion and nucleation limits (solve.f90:1118-1210)."""
    nz = self.nz
    shift = self.convective_max_boundary_shift
    if shift < 0:
        self.convecting_with_below = candidate.copy()
        return
    self.convecting_with_below = save.copy()
    if shift == 0:
        return

    i = 0
    while i < nz:
        if save[i]:
            lo = i
            while i < nz and save[i]:
                i += 1
            hi = i - 1
            if candidate[lo] and lo - shift >= 0:
                if np.any(candidate[lo - shift : lo]):
                    self.convecting_with_below[lo - shift : lo] = True
            if candidate[hi] and hi + shift < nz:
                if np.any(candidate[hi + 1 : hi + shift + 1]):
                    self.convecting_with_below[hi + 1 : hi + shift + 1] = True
            if not no_conv_to_rad and shift < (hi - lo + 1):
                if not np.any(candidate[lo : lo + shift]):
                    self.convecting_with_below[lo : lo + shift] = False
                if not np.any(candidate[hi - shift + 1 : hi + 1]):
                    self.convecting_with_below[hi - shift + 1 : hi + 1] = False
        else:
            i += 1

    # new convective islands require strong instability
    i = 0
    while i < nz:
        if not save[i] and candidate[i]:
            lo = i
            while i < nz and candidate[i] and not save[i]:
                i += 1
            hi = i - 1
            thresh = max(
                self.convective_hysteresis_min,
                self.convective_hysteresis_frac_on
                * np.max(np.abs(self.lapse_rate_intended[lo : hi + 1])),
            )
            if np.max(difference[lo : hi + 1]) > thresh:
                self.convecting_with_below[lo : min(hi + 1, lo + 2 * shift)] = True
        else:
            i += 1


def _hysteresis(self, frac, i):
    return max(self.convective_hysteresis_min, frac * abs(self.lapse_rate_intended[i]))


def _update_convecting_zones(self, P_i_surf, T_in, mode):
    """Classify convective vs radiative layers (solve.f90:899-1112)."""
    nz = self.nz
    save = self.convecting_with_below.copy()
    if mode != 3:
        _set_convecting_zones(self, np.zeros(nz, dtype=bool))

    x_in = np.array([T_in[ind - 1] for ind in self._inds_Tx])
    dFdt, dTdt = _objective(self, P_i_surf, x_in)
    frac_on, frac_off = self.convective_hysteresis_frac_on, self.convective_hysteresis_frac_off

    if mode == 1:
        jac = _jacobian_from_base(self, x_in, dTdt)
        try:
            deltaT = np.linalg.solve(jac, -dTdt)
        except np.linalg.LinAlgError:
            raise ClimaException('Linear solve failed in "update_convecting_zones"')

        alpha = min(max(0.0, self.convective_newton_step_size), 1.0)
        got = False
        for _ in range(20):
            T_pert = deltaT * alpha + x_in
            if np.min(T_pert) < 1.0:
                alpha *= 0.5
                continue
            try:
                T_full = np.array(T_in)
                for i, ind in enumerate(self._inds_Tx):
                    T_full[ind - 1] = T_pert[i]
                make_profile_rc(self, P_i_surf, T_full)
                lapse_rate_perturb = self.lapse_rate.copy()
                got = True
                break
            except ClimaException:
                alpha *= 0.5
            if alpha < 1e-8:
                break
        if not got:
            raise ClimaException("Failed to update convecting zones.")

        # restore at T_in (recomputes lapse_rate_intended)
        dFdt, dTdt = _objective(self, P_i_surf, x_in)
        difference = lapse_rate_perturb - self.lapse_rate_intended

        new_mask = np.zeros(nz, dtype=bool)
        for i in range(nz):
            if save[i]:
                new_mask[i] = not (difference[i] < -_hysteresis(self, frac_off, i))
            else:
                new_mask[i] = difference[i] > _hysteresis(self, frac_on, i)
        self.convecting_with_below = new_mask
        _apply_mask_limiter(self, save, new_mask.copy(), difference, False)

    elif mode == 2:
        difference = self.lapse_rate - self.lapse_rate_intended
        new_mask = save.copy()
        for i in range(nz):
            if not new_mask[i] and difference[i] > _hysteresis(self, frac_on, i):
                new_mask[i] = True
        self.convecting_with_below = new_mask
        _apply_mask_limiter(self, save, new_mask.copy(), difference, True)

    elif mode == 3:
        difference = self.lapse_rate - self.lapse_rate_intended
        self._prevent_overconvection_lock = np.maximum(self._prevent_overconvection_lock - 1, 0)
        i = 0
        while i < nz:
            if self.convecting_with_below[i]:
                while i < nz and self.convecting_with_below[i]:
                    i += 1
                hi = i - 1
                if hi >= nz - 1:
                    break
                if difference[hi + 1] > _hysteresis(self, frac_on, hi + 1):
                    self.convecting_with_below[hi + 1] = True
                    self._prevent_overconvection_lock[hi + 1] = 2
                elif self.lapse_rate[hi + 1] < -_hysteresis(self, frac_off, hi + 1):
                    if self._prevent_overconvection_lock[hi] == 0:
                        self.convecting_with_below[hi] = False
            else:
                i += 1
    else:
        raise ClimaException("Invalid mode in update_convecting_zones")

    _set_convecting_zones(self, self.convecting_with_below)

    if self.verbose:
        n_on = int(np.sum(~save & self.convecting_with_below))
        n_off = int(np.sum(save & ~self.convecting_with_below))
        print(f" Conv mask: +{n_on}  -{n_off}  zones -> {self.n_convecting_zones}")


# ----------------------------------------------------------------------------
# RCE outer loop (solve.f90:173-377)
# ----------------------------------------------------------------------------


def _solve(self, P_i_surf, x_init):
    """The nonlinear solve of one mask by ``rce_solve_strategy``: the solution."""
    strategy = self.rce_solve_strategy
    if strategy == RCE_SOLVE_HYBRJ_ONLY:
        x_sol, _, _, ok = _run_hybrj(self, P_i_surf, x_init)
        if not ok:
            raise ClimaException("hybrj root solve failed in RCE (HYBRJ_ONLY).")
    elif strategy == RCE_SOLVE_PTC_THEN_HYBRJ:
        x_sol, _, _, ok = _run_ptc(self, P_i_surf, x_init)
        if not ok:
            x_sol, _, _, ok = _run_hybrj(self, P_i_surf, x_sol)
        if not ok:
            raise ClimaException("root solve failed in RCE (PTC_THEN_HYBRJ).")
    elif strategy == RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ:
        x_sol, _, _, ok = _run_hybrj(self, P_i_surf, x_init)
        if not ok:
            x_sol, _, _, ok = _run_ptc(self, P_i_surf, x_init)
            if not ok:
                x_sol, _, _, ok = _run_hybrj(self, P_i_surf, x_sol)
        if not ok:
            raise ClimaException("root solve failed in RCE (HYBRJ_THEN_PTC_THEN_HYBRJ).")
    else:
        raise ClimaException("Invalid rce_solve_strategy.")
    return x_sol


def RCE(self, P_i_surf, T_surf_guess, T_guess, convecting_with_below=None,
        sp_custom=None, P_custom=None, mix_custom=None):
    """Compute full radiative-convective equilibrium. Returns converged bool."""
    P_i_surf = np.asarray(P_i_surf, dtype=np.float64)
    T_guess = np.asarray(T_guess, dtype=np.float64)
    if not self.double_radiative_grid:
        raise ClimaException(
            'AdiabatClimate must be initialized with "double_radiative_grid" '
            "set to True in order to call RCE."
        )
    if T_guess.shape != (self.nz,):
        raise ClimaException("T_guess has the wrong dimension")
    if self.max_rc_iters < 1:
        return False

    _initialize_custom_inputs(self, sp_custom, P_custom, mix_custom)

    converged = False
    T_in = np.concatenate([[T_surf_guess], T_guess])
    self.T_surf = float(T_surf_guess)
    self.T = T_guess.copy()
    self._prevent_overconvection_lock = np.zeros(self.nz, dtype=int)

    if convecting_with_below is not None:
        _set_convecting_zones(self, np.asarray(convecting_with_below, dtype=bool))
    else:
        self.convecting_with_below = np.zeros(self.nz, dtype=bool)
        _update_convecting_zones(self, P_i_surf, T_in, mode=1)

    mask_history = []
    perform_solve = True
    mode_update = 1 if self.max_rc_iters_convection > 1 else 2

    x_sol = None
    for it in range(1, self.max_rc_iters + 1):
        if self.verbose:
            print(f" Iteration = {it:3d}, Mode = {mode_update:3d}")

        if perform_solve:
            x_init = np.empty(len(self._inds_Tx))
            x_init[0] = self.T_surf
            for k in range(1, len(self._inds_Tx)):
                x_init[k] = self.T[self._inds_Tx[k] - 2]
            x_sol = _solve(self, P_i_surf, x_init)
            _objective(self, P_i_surf, x_sol)
        perform_solve = True

        mask_history.append(self.convecting_with_below.copy())
        _update_convecting_zones(self, P_i_surf, np.concatenate([[self.T_surf], self.T]),
                                 mode_update)
        mask_changed = not np.array_equal(mask_history[-1], self.convecting_with_below)

        if mode_update == 1:
            if not mask_changed:
                if self.require_mode2:
                    mode_update, perform_solve = 2, False
                    continue
                if self.prevent_overconvection:
                    mode_update, perform_solve = 3, False
                    continue
                converged = True
                break
            if it >= self.max_rc_iters_convection - 1:
                mode_update = 2
        elif mode_update == 2:
            if not mask_changed:
                if self.prevent_overconvection:
                    mode_update, perform_solve = 3, False
                    continue
                converged = True
                break
        elif not mask_changed:
            converged = True
            break

    if converged and self.verbose:
        print(" CONVERGED")

    # restore the mask used for the last solve and its solution state
    _set_convecting_zones(self, mask_history[-1])
    _objective(self, P_i_surf, x_sol)
    return converged


# attach methods
AdiabatClimate.make_profile_rc = make_profile_rc
AdiabatClimate.RCE = RCE
AdiabatClimate._set_convecting_zones = _set_convecting_zones
AdiabatClimate._update_convecting_zones = _update_convecting_zones
