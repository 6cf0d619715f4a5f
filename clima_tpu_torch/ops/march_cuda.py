"""The moist-adiabat march as one CUDA kernel (``csrc/march.cu``).

:func:`moist_adiabat_march_cuda` marches every column of a batch from the
surface to ``P_top`` in one launch: the K substeps of every interval of the
2 nz + 1 log-P grid, each the event-split RK4 with the tropopause crossing,
the isothermal stratosphere and the growth of the condensing set, as
``adiabat.profile`` computes them. Its twin, for the tests and for tensors on
the CPU, is ``adiabat.profile._march_torch``; ``make_profile_core`` chooses
between them by the device alone. What bounds the kernel on an H100 and
what its design does about it is described at the top of ``csrc/march.cu``.
``moist_adiabat_march_cuda.launches`` counts its launches. The kernel also
writes, per column, the event-split substeps it took and whether the
condensing set grew above the surface; while the program records
(``utils.profiling``), :func:`count_events` adds them to the counters
``moist_adiabat_march_cuda.event_splits`` and ``.onset_columns`` (the twin
to its own).

:func:`pack_tables` packs what the kernel reads of the profile parameters,
one row a gas and the physical constants, once per ``AdiabatParams``
(``AdiabatParams.march_tables``); :func:`sat_pressure_ref` and
:func:`heat_capacity_ref` read a gas's row as a lane of the kernel does, in
plain PyTorch, for the tests.
"""

from __future__ import annotations

import torch

from .. import constants as const
from ..physics.saturation import BIG
from ..utils import profiling
from .cuda_build import load_library

__all__ = ["moist_adiabat_march_cuda", "pack_tables", "count_events", "sat_pressure_ref",
           "heat_capacity_ref"]

# a gas's row: 3 regimes x (-a, b, K, D, a), T_triple, T_critical, mu/Rgas,
# P_ref, the molar mass, has_sat, then nr + 1 range edges and nr x 7
# heat-capacity coefficients (the offsets of csrc/march.cu)
T_TRIPLE, T_CRITICAL, MU_R, P_REF, MASS, HAS_SAT, TEMPS = 15, 16, 17, 18, 19, 20, 21
MAX_GASES = 32  # a column's group of lanes lies in one warp


def pack_tables(par):
    """What the kernel reads of ``par`` (an ``adiabat.profile.AdiabatParams``),
    in the dtype and on the device of its tensors: the per-gas table, (ng,
    22 + 8 nr) for nr heat-capacity ranges, and the constants Rgas, Rgas_si,
    G M (SI mass), the radius, N_avo k_boltz, G M (cgs), BIG and F_DRY_MIN,
    each the number the twin's expressions form before they meet a tensor."""
    from ..adiabat.profile import F_DRY_MIN, G_GRAV_CGS

    s, th, ng = par.sat, par.thermo, par.gas_masses.shape[0]
    dtype, device = par.gas_masses.dtype, par.gas_masses.device
    col = lambda x: x[:, None]  # noqa: E731
    tables = torch.cat([s.branch_table.reshape(ng, 15), col(s.T_triple), col(s.T_critical),
                        col(s.mu_R), col(s.P_ref), col(par.gas_masses),
                        col(s.has_sat.to(dtype)), th.temps, th.poly.reshape(ng, -1)], dim=1)
    consts = torch.tensor([const.Rgas, const.Rgas_si, const.G_grav * (par.planet_mass / 1.0e3),
                           par.planet_radius, const.N_avo * const.k_boltz,
                           G_GRAV_CGS * par.planet_mass, BIG, F_DRY_MIN], dtype=dtype,
                          device=device)
    return tables.contiguous(), consts


def moist_adiabat_march_cuda(par, RH, T_surf, T_trop, mask0, r_dry, P_e, f_i_surf):
    """The march of B columns on the card, in one launch.

    ``par`` an ``AdiabatParams`` (its tables packed once: ``par.march_tables``);
    RH (ng,) or (B, ng); T_surf and T_trop (B,); the surface condensing set
    mask0 (B, ng) bool, the dry proportions r_dry (B, ng), the edge pressures
    P_e (B, 2 nz + 1) and the surface mixing ratios f_i_surf (B, ng), as
    ``make_profile_core`` sets them up. Returns (T_e, z_e, f_i_e, P_trop,
    events): (B, 2 nz + 1), (B, 2 nz + 1), (B, 2 nz + 1, ng), (B,), P_trop -1
    where no tropopause was reached, and events (B, 2) int32, per column the
    substeps below the tropopause whose step was split at a latent-heat kink
    or a condensation onset, and 1 where the condensing set grew above the
    surface. CUDA tensors of float32 or float64 only. The launch alone is the
    span ``adiabat.profile.march.kernel``.
    """
    device, dtype = T_surf.device, T_surf.dtype
    if device.type != "cuda":
        raise ValueError(f"the march kernel runs on a CUDA device, not {device}; "
                         "call adiabat.profile._march_torch for the twin")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the march kernel takes float32 or float64, not {dtype}")
    tables, consts = par.march_tables
    if tables.dtype != dtype or tables.device != device:
        raise ValueError("the profile parameters and the columns differ in dtype or device")
    ng = tables.shape[0]
    if ng > MAX_GASES:
        raise ValueError(f"the march kernel takes at most {MAX_GASES} gases, not {ng}")
    B, ne = P_e.shape
    T_e = torch.empty((B, ne), dtype=dtype, device=device)
    z_e = torch.empty_like(T_e)
    f_i_e = torch.empty((B, ne, ng), dtype=dtype, device=device)
    P_trop = torch.empty((B,), dtype=dtype, device=device)
    events = torch.empty((B, 2), dtype=torch.int32, device=device)
    if B == 0:
        return T_e, z_e, f_i_e, P_trop, events
    args = [t.to(device=device, dtype=dtype).contiguous()
            for t in (T_surf, T_trop, torch.as_tensor(RH).expand(B, ng), r_dry, f_i_surf, P_e)]
    T_surf, T_trop, RH, r_dry, f_i_surf, P_e = args
    mask0 = mask0.to(device=device, dtype=torch.bool).contiguous()
    lP = torch.log(P_e)
    nr = par.thermo.temps.shape[1] - 1
    fn = load_library("march")["clima_march"]
    with profiling.span("adiabat.profile.march.kernel"):
        status = fn(int(dtype == torch.float64), B, ng, nr, ne, par.substeps, par.n_condensible,
                    tables.data_ptr(), consts.data_ptr(), T_surf.data_ptr(), T_trop.data_ptr(),
                    RH.data_ptr(), r_dry.data_ptr(), mask0.data_ptr(), f_i_surf.data_ptr(),
                    P_e.data_ptr(), lP.data_ptr(), T_e.data_ptr(), z_e.data_ptr(),
                    f_i_e.data_ptr(), P_trop.data_ptr(), events.data_ptr(),
                    torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"march kernel launch failed: error {status}")
    moist_adiabat_march_cuda.launches += 1
    count_events(moist_adiabat_march_cuda, events)
    return T_e, z_e, f_i_e, P_trop, events


moist_adiabat_march_cuda.launches = 0
moist_adiabat_march_cuda.event_splits = moist_adiabat_march_cuda.onset_columns = 0


def count_events(fn, events):
    """Add a march's per-column ``events`` (B, 2) (split substeps, onset) to
    ``fn.event_splits`` and ``fn.onset_columns``, while the program records
    and the stream is not being captured; otherwise nothing happens, so an
    unrecorded call never reads the device."""
    if not profiling.is_recording() or (events.is_cuda
                                        and torch.cuda.is_current_stream_capturing()):
        return
    splits, onsets = events.sum(dim=0).tolist()
    fn.event_splits += splits
    fn.onset_columns += onsets


def _row_branch(tables, T):
    """The regime constants (-a, b, K, D, a) each lane selects at T (...):
    (..., ng) each."""
    Tx = T[..., None]
    regime = (Tx > tables[:, T_TRIPLE]).long() + (Tx >= tables[:, T_CRITICAL]).long()
    rows = tables[:, :15].reshape(-1, 3, 5)
    return rows[torch.arange(tables.shape[0]), regime].unbind(-1)


def sat_pressure_ref(tables, T):
    """Saturation pressure of every gas at T (...) -> (..., ng), read from
    the packed rows as a lane of the kernel reads its own (RH 1)."""
    neg_a, b, K, D, _ = _row_branch(tables, T)
    Tx = T[..., None]
    ps = tables[:, P_REF] * torch.exp(tables[:, MU_R] * ((K + (neg_a / Tx + b * torch.log(Tx)))
                                                         - D))
    return torch.where(tables[:, HAS_SAT] != 0, ps, BIG)


def heat_capacity_ref(tables, nr, T):
    """Heat capacity J/(mol K) of every gas at T (...) -> (..., ng) from the
    packed rows (nr ranges), as a lane of the kernel evaluates it: the range
    counted over the edges, its polynomial, NaN outside the edges."""
    edges = tables[:, TEMPS:TEMPS + nr + 1]
    Tx = T[..., None]
    idx = torch.clamp(torch.sum(Tx[..., None] >= edges[:, :-1], dim=-1) - 1, 0, nr - 1)
    coef = tables[:, TEMPS + nr + 1:].reshape(tables.shape[0], nr, 7)
    c = coef[torch.arange(tables.shape[0]), idx]  # (..., ng, 7)
    inv, T2 = 1.0 / Tx, Tx * Tx
    cp = (c[..., 0] * (inv * inv) + c[..., 1] * inv + c[..., 2] + c[..., 3] * Tx + c[..., 4] * T2
          + c[..., 5] * (T2 * Tx) + c[..., 6] * (T2 * T2))
    return torch.where((Tx >= edges[:, 0]) & (Tx < edges[:, -1]), cp, torch.nan)
