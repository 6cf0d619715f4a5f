"""Batched end-to-end column pipelines on the model's device.

The port of ``clima_tpu/parallel/pipeline.py``: the column model (moist
adiabat, altitude solve, opacity, two-stream RT, TOA fluxes) and a damped
Newton surface-temperature solve as functions of a batch of columns
(T_surf (B,), P_i_surf (B, ng)) that stay on the device, where the JAX
package writes them per column and batches them with ``vmap``.

Columns never interact, so sharding them over devices is data parallelism
with one process per device, the idiom of ``torch.distributed``:
:func:`initialize_distributed` joins the process group, :func:`make_mesh`
gives the 1-D ``columns`` mesh over its ranks and :func:`shard_columns` the
placement of the column axis on it. Given ``mesh=``, each batched entry
point (the two here, the five solves of :mod:`.solvers` and
``adiabat.rce_device.batched_rce``) takes every rank's copy of the whole
batch, as a JAX program whose processes all pass the same global array,
runs the single-device code on the rank's contiguous share of the columns
and all-gathers the per-column results, so that every rank returns the
whole batch. The only other traffic is what the global loop decisions read
(the iteration count of :func:`batched_surface_temperature`, the chunk
decisions of ``batched_rce``), gathered the same way.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as const
from ..adiabat.altitude import compute_altitude_core
from ..adiabat.profile import AdiabatParams, make_profile_core
from ..radtran.opacity import compute_opacity
from ..radtran.radiate import integrate_fluxes, radiate_ir, radiate_solar
from ..utils.profiling import request, span

__all__ = [
    "make_column_fns",
    "batched_toa_fluxes",
    "batched_surface_temperature",
    "make_mesh",
    "shard_columns",
    "initialize_distributed",
]

def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           backend=None):
    """Join the process group of a multi-process run: one process per device.

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` (the
    world size) and ``process_id`` (this process's rank) are read from
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) where
    they are None. ``backend`` defaults to NCCL where there is a CUDA device
    and gloo elsewhere; gloo also serves ranks that share one card, which
    NCCL refuses. Afterwards the current CUDA device is the rank's own
    (LOCAL_RANK, else the rank, modulo the host's cards), so that
    ``resolve_device()`` and every model built later land on it. Build the
    mesh with :func:`make_mesh`; the only traffic between ranks is the
    gathered per-column results and the loop decisions.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None else int(num_processes),
                            rank=-1 if process_id is None else int(process_id))
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def make_mesh(n_devices=None, devices=None):
    """1-D ``columns`` mesh (a ``DeviceMesh``) over every rank of the process group.

    One device per rank: ``n_devices``, where given, must be the world size,
    and ``devices``, where given, the world's ranks in order. Without a
    process group this is a one-rank mesh on the current device that starts
    none, so ``mesh=make_mesh()`` works in a plain script as it does in the
    JAX package without ``initialize_distributed``. The entry points run a
    one-rank mesh as ``mesh=None``: it holds the whole batch.
    """
    from torch.distributed.device_mesh import DeviceMesh

    grouped = dist.is_initialized()
    ranks = list(range(dist.get_world_size() if grouped else 1))
    if n_devices is not None and int(n_devices) != len(ranks):
        raise ValueError(f"n_devices={n_devices}: a mesh spans all {len(ranks)} ranks of the "
                         "process group, one device per rank")
    if devices is not None and [int(d) for d in devices] != ranks:
        raise ValueError(f"devices={list(devices)}: a mesh spans the process group's ranks "
                         f"{ranks} in order, one device per rank")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if grouped:
        return DeviceMesh(device_type, ranks, mesh_dim_names=("columns",))
    # the mesh of rank 0 alone, with no process group behind it
    return DeviceMesh(device_type, ranks, mesh_dim_names=("columns",), _init_backend=False,
                      _rank=0)


def shard_columns(mesh):
    """The placement of the leading (column) axis on ``mesh``: ``(mesh,
    [Shard(0)])``, as ``distribute_tensor(x, *shard_columns(mesh))`` takes it
    (the counterpart of ``NamedSharding(mesh, P("columns"))``)."""
    from torch.distributed.tensor import Shard

    return mesh, [Shard(0)]


def _local_columns(mesh, *arrays):
    """This rank's contiguous share of a batch of columns.

    ``arrays[0]`` (B, ...) sets the batch; it and every other array with B
    rows are cut to the rank's B / n rows, the rest (numbers, broadcast
    values, None) pass as they are. Without a mesh everything passes. A
    batch that does not divide over the mesh raises, as placing it on an
    indivisible ``NamedSharding`` does in JAX.
    """
    if mesh is None or mesh.size() == 1:
        return arrays
    n, B = mesh.size(), len(arrays[0])
    if B % n:
        raise ValueError(f"a batch of {B} columns does not divide over a mesh of {n} ranks")
    k = B // n
    share = slice(mesh.get_local_rank() * k, (mesh.get_local_rank() + 1) * k)
    return tuple(a[share] if a is not None and np.ndim(a) > 0 and len(a) == B else a
                 for a in arrays)


def _gather_columns(mesh, out):
    """Per-column results of every rank joined along dim 0, on every rank.

    ``out``: a tensor, or a tuple, list or dict of them (nested); other
    values pass as they are. Every rank holds its own share of the columns
    in rank order, so the result is the whole batch in its original order.
    """
    if mesh is None or mesh.size() == 1:
        return out
    if isinstance(out, dict):
        return {k: _gather_columns(mesh, v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_gather_columns(mesh, v) for v in out)
    if not torch.is_tensor(out):
        return out
    x = out.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=mesh.get_group(0))
    return torch.cat(parts)


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
        with span("adiabat.column.layers"):
            P_c = prof["P_e"][:, 1::2]
            T_c = prof["T_e"][:, 1::2]
            f_c = prof["f_i_e"][:, 1::2]
            mubar = torch.sum(f_c * gas_masses, dim=-1)
            mubar_surf = torch.sum(prof["f_i_e"][:, 0] * gas_masses, dim=-1)
        alt = compute_altitude_core(
            P_c, T_c, mubar, prof["P_surf"], T_surf, mubar_surf, par.P_top,
            par.planet_mass, par.planet_radius, -1.0,
        )
        with span("adiabat.column.amounts"):
            density = P_c / (const.k_boltz * T_c)
            dens = f_c * density[..., None]
            # N_atmos mol/cm^2 (clima_adiabat.f90:449-453 semantics)
            N_atmos = torch.sum(dens * alt["dz"][..., None], dim=1) / const.N_avo
        return dict(prof=prof, P_c=P_c, T_c=T_c, dens=dens, dz=alt["dz"],
                    P_surf=prof["P_surf"], N_atmos=N_atmos, N_surface=prof["N_surface"])

    def profile_only(T_surf, P_i_surf, T_trop):
        with request("adiabat.profile_only"):
            b = _build_profile(T_surf, P_i_surf, T_trop)
            return dict(P_surf=b["P_surf"], N_atmos=b["N_atmos"], N_surface=b["N_surface"],
                        f_i_surf=b["prof"]["f_i_e"][:, 0])

    def column_model(T_surf, P_i_surf, T_trop):
        with request("adiabat.column_model"):
            b = _build_profile(T_surf, P_i_surf, T_trop)
            T_c, P_c, dens = b["T_c"], b["P_c"], b["dens"]

            # doubled RT grid + 2 ghost layers (clima_adiabat.f90:729-773)
            def ghost(a):
                return torch.cat([torch.repeat_interleave(a, 2, dim=1), a[:, -1:], a[:, -1:]],
                                 dim=1)

            with span("adiabat.column.grid"):
                T_r, P_r, dens_r, dz_r = ghost(T_c), ghost(P_c), ghost(dens), ghost(0.5 * b["dz"])
                P_r_bar = P_r / 1.0e6
            opr = compute_opacity(op, P_r_bar, T_r, dens_r, dz_r)
            ir = radiate_ir(ir_slice, freq_master, wbin, opr, emissivity, has_hard, ir_tau_min,
                            T_surf, T_r)
            fup_ir, fdn_ir = integrate_fluxes(
                ir["fup_a"], ir["fdn_a"], freq_master[ir_slice[0]: ir_slice[1] + 2])
            sol = radiate_solar(sol_slice, freq_master, wavl_master, wbin, opr, albedo, diurnal,
                                photons, zenith_u, zenith_w, compute_amean=False)
            fup_sol, fdn_sol = integrate_fluxes(
                sol["fup_a"], sol["fdn_a"], freq_master[sol_slice[0]: sol_slice[1] + 2])
            with span("adiabat.column.toa"):
                ISR = fdn_sol[:, -1] - fup_sol[:, -1]
                OLR = -(fdn_ir[:, -1] - fup_ir[:, -1])
                return dict(ISR=ISR, OLR=OLR, fup_sol_toa=fup_sol[:, -1],
                            fdn_sol_toa=fdn_sol[:, -1], P_surf=b["P_surf"], N_atmos=b["N_atmos"],
                            N_surface=b["N_surface"], f_i_surf=b["prof"]["f_i_e"][:, 0])

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
    inputs may be numbers, arrays or tensors on any device. With ``mesh``
    (:func:`make_mesh`) each rank computes its share of the columns and
    returns the whole batch."""
    P_i_surf_batch, T_surf_batch = _local_columns(mesh, P_i_surf_batch, T_surf_batch)
    t = lambda x: torch.as_tensor(x, dtype=c.dtype, device=c.device)
    return _gather_columns(mesh, make_column_fns(c)["toa_fluxes"](t(T_surf_batch),
                                                                  t(P_i_surf_batch)))


def batched_surface_temperature(c, P_i_surf_batch, T_guess=280.0, max_iter=30, mesh=None):
    """Solve ISR-OLR=0 for every column in the batch on ``c.device``.

    Every lane steps until all lanes have converged or ``max_iter`` steps
    were taken, as the JAX package's ``while_loop`` does (converged lanes
    keep their value). Returns (T_surf (B,), resid (B,), converged (B,),
    iterations). With ``mesh`` each rank steps its share of the columns until
    they have converged and returns the whole batch; ``iterations`` is the
    largest count over the ranks, the global loop's: a converged lane keeps
    its value, so the steps a rank skips change none.
    """
    (P_i_surf_batch,) = _local_columns(mesh, P_i_surf_batch)
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
    logT, resid, conv = _gather_columns(mesh, state)
    iters = _gather_columns(mesh, torch.tensor([iters], device=c.device)).max()
    return 10.0**logT, resid, conv, int(iters)
