"""Batched end-to-end column pipelines on the model's device.

The port of ``clima_tpu/parallel/pipeline.py``: the column model (moist
adiabat, altitude solve, opacity, two-stream RT, TOA fluxes) and a damped
Newton surface-temperature solve as functions of a batch of columns
(T_surf (B,), P_i_surf (B, ng)) that stay on the device, where the JAX
package writes them per column and batches them with ``vmap``. The mesh and
multi-process helpers (``make_mesh``, ``shard_columns``,
``initialize_distributed``) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as const
from ..adiabat.altitude import compute_altitude_core
from ..adiabat.profile import AdiabatParams, make_profile_core
from ..radtran.opacity import compute_opacity
from ..radtran.radiate import integrate_fluxes, radiate_ir, radiate_solar

__all__ = ["make_column_fns", "batched_toa_fluxes", "batched_surface_temperature"]


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mesh: sharding columns over devices (make_mesh/shard_columns, the multi-device "
            "item of ROADMAP Queue 1) is not ported; pass mesh=None")


def make_column_fns(c):
    """Build batched column functions from an AdiabatClimate instance.

    Returns dict with, for T_surf (B,), P_i_surf (B, ng) and T_trop (B,) or a
    float, tensors on ``c.device``:
      toa_fluxes(T_surf, P_i_surf) -> (ISR, OLR), each (B,)
      column_model(T_surf, P_i_surf, T_trop) -> dict(ISR, OLR, fup_sol_toa,
        fdn_sol_toa, P_surf, N_atmos, N_surface, f_i_surf)
      profile_only(T_surf, P_i_surf, T_trop) -> dict(P_surf, N_atmos,
        N_surface, f_i_surf)                       [no RT]
      newton_step(state, P_i_surf) -> state       [one damped-Newton step on
                                                   log10(T_surf)]
    """
    par: AdiabatParams = c._par  # as the JAX package: the constructor's P_top
    rad = c.rad
    op = rad.op
    dev, dt = c.device, c.dtype
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dt, device=dev)
    RH = t(c.RH)
    T_trop_default = float(c.T_trop)
    ir_slice = (rad.ir.ind_start, rad.ir.ind_end)
    sol_slice = (rad.sol.ind_start, rad.sol.ind_end)
    freq_master, wavl_master, wbin = op.freq, op.wavl, op.kset.wbin
    emissivity = t(rad.surface_emissivity)
    albedo = t(rad.surface_albedo)
    photons = t(rad.photons_sol * rad.photon_scale_factor)
    zenith_u = t(rad.zenith_u)
    zenith_w = t(rad.zenith_weights)
    diurnal = rad.diurnal_fac
    has_hard = rad.has_hard_surface
    ir_tau_min = rad.ir_tau_min
    gas_masses = par.gas_masses

    def _build_profile(T_surf, P_i_surf, T_trop):
        """Profile + altitude + reservoir bookkeeping (no RT)."""
        prof = make_profile_core(par, RH, T_surf, P_i_surf, T_trop)
        P_c = prof["P_e"][:, 1::2]
        T_c = prof["T_e"][:, 1::2]
        f_c = prof["f_i_e"][:, 1::2]
        mubar = torch.sum(f_c * gas_masses, dim=-1)
        mubar_surf = torch.sum(prof["f_i_e"][:, 0] * gas_masses, dim=-1)
        alt = compute_altitude_core(
            P_c, T_c, mubar, prof["P_surf"], T_surf, mubar_surf, par.P_top,
            par.planet_mass, par.planet_radius, -1.0,
        )
        density = P_c / (const.k_boltz * T_c)
        dens = f_c * density[..., None]
        # N_atmos mol/cm^2 (clima_adiabat.f90:449-453 semantics)
        N_atmos = torch.sum(dens * alt["dz"][..., None], dim=1) / const.N_avo
        return dict(prof=prof, P_c=P_c, T_c=T_c, dens=dens, dz=alt["dz"],
                    P_surf=prof["P_surf"], N_atmos=N_atmos, N_surface=prof["N_surface"])

    def profile_only(T_surf, P_i_surf, T_trop):
        b = _build_profile(T_surf, P_i_surf, T_trop)
        return dict(P_surf=b["P_surf"], N_atmos=b["N_atmos"], N_surface=b["N_surface"],
                    f_i_surf=b["prof"]["f_i_e"][:, 0])

    def column_model(T_surf, P_i_surf, T_trop):
        b = _build_profile(T_surf, P_i_surf, T_trop)
        T_c, P_c, dens = b["T_c"], b["P_c"], b["dens"]

        # doubled RT grid + 2 ghost layers (clima_adiabat.f90:729-773)
        def ghost(a):
            return torch.cat([torch.repeat_interleave(a, 2, dim=1), a[:, -1:], a[:, -1:]],
                             dim=1)

        T_r, P_r, dens_r, dz_r = ghost(T_c), ghost(P_c), ghost(dens), ghost(0.5 * b["dz"])
        opr = compute_opacity(op, P_r / 1.0e6, T_r, dens_r, dz_r)
        ir = radiate_ir(ir_slice, freq_master, wbin, opr, emissivity, has_hard, ir_tau_min,
                        T_surf, T_r)
        fup_ir, fdn_ir = integrate_fluxes(
            ir["fup_a"], ir["fdn_a"], freq_master[ir_slice[0]: ir_slice[1] + 2])
        sol = radiate_solar(sol_slice, freq_master, wavl_master, wbin, opr, albedo, diurnal,
                            photons, zenith_u, zenith_w, compute_amean=False)
        fup_sol, fdn_sol = integrate_fluxes(
            sol["fup_a"], sol["fdn_a"], freq_master[sol_slice[0]: sol_slice[1] + 2])
        ISR = fdn_sol[:, -1] - fup_sol[:, -1]
        OLR = -(fdn_ir[:, -1] - fup_ir[:, -1])
        return dict(ISR=ISR, OLR=OLR, fup_sol_toa=fup_sol[:, -1], fdn_sol_toa=fdn_sol[:, -1],
                    P_surf=b["P_surf"], N_atmos=b["N_atmos"], N_surface=b["N_surface"],
                    f_i_surf=b["prof"]["f_i_e"][:, 0])

    def toa_fluxes(T_surf, P_i_surf):
        m = column_model(T_surf, P_i_surf, T_trop_default)
        return m["ISR"], m["OLR"]

    def newton_step(state, P_i_surf):
        """One damped FD-Newton step on log10(T_surf) for ISR-OLR=0, every lane.

        state = (logT, resid, converged), each (B,). Mirrors the reference's
        hybrd1 1-DOF solve (clima_adiabat.f90:882-961) as the JAX package's
        vectorized form does.
        """
        logT, _, _ = state
        eps = 1.0e-4
        isr0, olr0 = toa_fluxes(10.0**logT, P_i_surf)
        isr1, olr1 = toa_fluxes(10.0 ** (logT + eps), P_i_surf)
        r0 = isr0 - olr0
        r1 = isr1 - olr1
        dr = (r1 - r0) / eps
        step = -r0 / torch.where(torch.abs(dr) > 1e-30, dr, 1e-30)
        step = torch.clamp(step, -0.05, 0.05)  # damping: <= ~12% in T
        scale = torch.clamp(torch.abs(isr0), min=1.0)
        new_conv = torch.abs(r0) < 1.0e-6 * scale
        logT_new = torch.where(new_conv, logT, logT + step)
        return (logT_new, r0, new_conv)

    return dict(toa_fluxes=toa_fluxes, newton_step=newton_step,
                column_model=column_model, profile_only=profile_only)


def batched_toa_fluxes(c, T_surf_batch, P_i_surf_batch, mesh=None):
    """Batched TOA fluxes (ISR, OLR), each (B,), on ``c.device``. The
    inputs may be numbers, arrays or tensors on any device. Sharding over a
    device mesh is not ported: ``mesh`` must be None."""
    _no_mesh(mesh)
    t = lambda x: torch.as_tensor(x, dtype=c.dtype, device=c.device)
    return make_column_fns(c)["toa_fluxes"](t(T_surf_batch), t(P_i_surf_batch))


def batched_surface_temperature(c, P_i_surf_batch, T_guess=280.0, max_iter=30, mesh=None):
    """Solve ISR-OLR=0 for every column in the batch on ``c.device``.

    Every lane steps until all lanes have converged or ``max_iter`` steps
    were taken, as the JAX package's ``while_loop`` does (converged lanes
    keep their value). Returns (T_surf (B,), resid (B,), converged (B,),
    iterations). Sharding over a device mesh is not ported: ``mesh`` must be
    None.
    """
    _no_mesh(mesh)
    step = make_column_fns(c)["newton_step"]
    P_i = torch.as_tensor(P_i_surf_batch, dtype=c.dtype, device=c.device)
    B = P_i.shape[0]
    state = (torch.full((B,), np.log10(T_guess), dtype=c.dtype, device=c.device),
             torch.full((B,), torch.inf, dtype=c.dtype, device=c.device),
             torch.zeros(B, dtype=torch.bool, device=c.device))
    iters = 0
    while iters < max_iter and not bool(torch.all(state[2])):
        state = step(state, P_i)
        iters += 1
    logT, resid, conv = state
    return 10.0**logT, resid, conv, iters
