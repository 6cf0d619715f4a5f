"""Toon et al. (1989) two-stream radiative transfer, batched, plain PyTorch.

Re-implements ``src/radtran/clima_radtran_twostream.f90`` with identical
coefficient sets (quadrature + delta-Eddington for solar, hemispheric mean
with linear-in-tau Planck source for IR, including the thin-layer ``tau_min``
guard and the hard-surface vs PICASO-style lower thermal BC). Every function
takes arbitrary leading batch dims with ``nz`` last (TOA-down, as in the
reference core); outputs are edge quantities (..., nz+1) with index 0 = TOA.

These are the twins of the CUDA kernels in :mod:`.twostream_cuda`: the same
math as the JAX package's XLA path, solved by 2x2-block PCR, or by Thomas
after ``set_tridiag_method("thomas")``. ``set_pallas_mode`` chooses between
the kernels and these twins in the wrappers of :mod:`.twostream_cuda`.
"""

from __future__ import annotations

import torch

from .tridiag import block2_pcr_components_multi, tridiag_batched_last
from .. import constants as const

__all__ = [
    "two_stream_solar",
    "two_stream_solar_multi",
    "two_stream_solar_multi_weighted",
    "two_stream_ir",
    "two_stream_ir_weighted",
    "set_tridiag_method",
]

_SQRT3 = 3.0**0.5

# the twins' solve: "pcr" (2x2-block parallel cyclic reduction) or "thomas"
# (the interleaved scalar system, sequential over its 2*nz rows)
_TRIDIAG_METHOD = "pcr"


def set_tridiag_method(name: str):
    """Select the twins' tridiagonal solve: "pcr" (2x2-block PCR, the
    default) or "thomas" (the scalar Thomas recurrence on the interleaved
    system). It applies to every twin, the multi-zenith one included (in the
    JAX package its multi-zenith solve is always block PCR); the CUDA kernels
    keep their own 2x2-block elimination, as the Pallas kernels keep theirs."""
    global _TRIDIAG_METHOD
    if name not in ("pcr", "thomas"):
        raise ValueError(name)
    _TRIDIAG_METHOD = name


# which side the wrappers of .twostream_cuda take (see set_pallas_mode)
_PALLAS_MODE = "auto"


def set_pallas_mode(name: str):
    """The switch of the two-stream wrappers of :mod:`.twostream_cuda`, the
    JAX package's name for its choice between the Pallas kernels and XLA.
    Here the tensor's device chooses, the CUDA kernel for a CUDA tensor and
    the twin of this module for a CPU tensor, and the mode only refuses:

    - "auto" (the default): nothing;
    - "never": a CUDA tensor (to run a twin on the card, call it);
    - "always": a CPU tensor.
    """
    global _PALLAS_MODE
    if name not in ("auto", "never", "always"):
        raise ValueError(name)
    _PALLAS_MODE = name


def _solve_rows(A_ev, B_ev, D_ev, A_od, B_od, D_od, E_ev, E_od):
    """The 2*nz system from its even/odd rows, for right-hand sides E (nrhs,
    ..., nz) sharing the matrix rows (..., nz): (y1, y2), each like E."""
    if _TRIDIAG_METHOD == "pcr":
        return block2_pcr_components_multi(A_ev, B_ev, D_ev, A_od, B_od, D_od, E_ev, E_od)
    shape = torch.broadcast_shapes(A_ev.shape, E_ev.shape)

    def interleave(ev, od):
        return torch.stack([ev.expand(shape), od.expand(shape)], dim=-1).reshape(
            shape[:-1] + (2 * shape[-1],))

    sol = tridiag_batched_last(interleave(A_ev, A_od), interleave(B_ev, B_od),
                               interleave(D_ev, D_od), interleave(E_ev, E_od))
    return sol[..., 0::2], sol[..., 1::2]


def _cumsum_last(x):
    """Inclusive cumsum along the last axis via log2(n) doubling shifts (the
    summation order of the JAX package's kernels)."""
    n = x.shape[-1]
    k = 1
    while k < n:
        x = x + torch.cat([torch.zeros_like(x[..., :k]), x[..., :-k]], dim=-1)
        k *= 2
    return x


def _es(lam, cap_gam, tau):
    wrk = torch.exp(-lam * tau)
    e1 = 1.0 + cap_gam * wrk
    e2 = 1.0 - cap_gam * wrk
    e3 = cap_gam + wrk
    e4 = cap_gam - wrk
    return e1, e2, e3, e4


def _matrix_rows(e1, e2, e3, e4, Rsfc):
    """Even/odd coefficient rows of the 2*nz two-stream system (Eqs. 39-43).

    Zenith-independent: the matrix depends only on the e-coefficients and the
    surface reflectivity, so all zenith angles share one elimination.
    """
    zeros = torch.zeros_like(e1[..., :1])
    Rsfc = Rsfc[..., None]

    # rows at 0-based even positions (Fortran odd l): [row0, j=0..nz-2]
    A_ev = torch.cat([zeros, e2[..., :-1] * e3[..., :-1] - e4[..., :-1] * e1[..., :-1]], -1)
    B_ev = torch.cat([e1[..., :1], e1[..., :-1] * e1[..., 1:] - e3[..., :-1] * e3[..., 1:]], -1)
    D_ev = torch.cat([-e2[..., :1], e3[..., :-1] * e4[..., 1:] - e1[..., :-1] * e2[..., 1:]], -1)

    # rows at 0-based odd positions (Fortran even l): [j=0..nz-2, last row]
    A_od = torch.cat([e2[..., 1:] * e1[..., :-1] - e3[..., :-1] * e4[..., 1:],
                      e1[..., -1:] - Rsfc * e3[..., -1:]], -1)
    B_od = torch.cat([e2[..., :-1] * e2[..., 1:] - e4[..., :-1] * e4[..., 1:],
                      e2[..., -1:] - Rsfc * e4[..., -1:]], -1)
    D_od = torch.cat([e1[..., 1:] * e4[..., 1:] - e2[..., 1:] * e3[..., 1:], zeros], -1)
    return A_ev, B_ev, D_ev, A_od, B_od, D_od


def _rhs_rows(e1, e2, e3, e4, cp0, cpb, cm0, cmb, Rsfc, Ssfc):
    """Even/odd RHS rows of the two-stream system (the u0-dependent part)."""
    Rsfc = Rsfc[..., None]
    E_ev = torch.cat([
        -cm0[..., :1],
        e3[..., :-1] * (cp0[..., 1:] - cpb[..., :-1])
        + e1[..., :-1] * (cmb[..., :-1] - cm0[..., 1:]),
    ], -1)
    E_od = torch.cat([
        e2[..., 1:] * (cp0[..., 1:] - cpb[..., :-1])
        - e4[..., 1:] * (cm0[..., 1:] - cmb[..., :-1]),
        Ssfc - cpb[..., -1:] + Rsfc * cmb[..., -1:],
    ], -1)
    return E_ev, E_od


def _solar_coefficients(tau_in, w0_in, gt_in):
    """Delta-Eddington scaling and the zenith-independent coefficients."""
    tau = tau_in * (1.0 - w0_in * gt_in * gt_in)
    w0 = w0_in * (1.0 - gt_in * gt_in) / (1.0 - w0_in * gt_in * gt_in)
    gt = gt_in / (1.0 + gt_in)
    gam1 = _SQRT3 * (2.0 - w0 * (1.0 + gt)) / 2.0
    gam2 = _SQRT3 * w0 * (1.0 - gt) / 2.0
    lam = torch.sqrt(gam1**2 - gam2**2)
    cap_gam = gam2 / (gam1 + lam)
    tauc = torch.cat([torch.zeros_like(tau[..., :1]), _cumsum_last(tau)], dim=-1)
    return tau, w0, gt, gam1, gam2, lam, _es(lam, cap_gam, tau), tauc


def _solar(tau_in, w0_in, gt_in, u0, Rsfc):
    """Solar solve for zenith cosines ``u0`` of shape (nrhs, ..., 1)."""
    tau, w0, gt, gam1, gam2, lam, (e1, e2, e3, e4), tauc = _solar_coefficients(
        tau_in, w0_in, gt_in)
    u1 = 1.0 / _SQRT3
    Fs_pi = 1.0

    gam3 = (1.0 - _SQRT3 * gt[None] * u0) / 2.0
    gam4 = 1.0 - gam3
    facp = w0[None] * Fs_pi * ((gam1[None] - 1.0 / u0) * gam3 + gam4 * gam2[None])
    facm = w0[None] * Fs_pi * ((gam1[None] + 1.0 / u0) * gam4 + gam2[None] * gam3)
    et0 = torch.exp(-tauc[None, ..., :-1] / u0)
    etb = et0 * torch.exp(-tau[None] / u0)
    denom = lam[None] ** 2 - 1.0 / u0**2

    direct = torch.cat([u0 * Fs_pi * torch.ones_like(etb[..., :1]), u0 * Fs_pi * etb], -1)
    cp0 = et0 * facp / denom
    cpb = etb * facp / denom
    cm0 = et0 * facm / denom
    cmb = etb * facm / denom
    Ssfc = Rsfc[None, ..., None] * direct[..., -1:]

    A_ev, B_ev, D_ev, A_od, B_od, D_od = _matrix_rows(e1, e2, e3, e4, Rsfc)
    E_ev, E_od = _rhs_rows(e1[None], e2[None], e3[None], e4[None],
                           cp0, cpb, cm0, cmb, Rsfc, Ssfc)
    y1, y2 = _solve_rows(A_ev, B_ev, D_ev, A_od, B_od, D_od, E_ev, E_od)

    e1, e2, e3, e4 = e1[None], e2[None], e3[None], e4[None]
    top = y1[..., :1] * e3[..., :1] - y2[..., :1] * e4[..., :1] + cp0[..., :1]
    amean = torch.cat([
        (1.0 / u1) * top + direct[..., :1] / u0,
        (1.0 / u1) * (y1 * (e1 + e3) + y2 * (e2 + e4) + cpb + cmb) + direct[..., 1:] / u0,
    ], -1)
    fup = torch.cat([top, y1 * e1 + y2 * e2 + cpb], -1)
    fdn = torch.cat([direct[..., :1], y1 * e3 + y2 * e4 + cmb + direct[..., 1:]], -1)
    surface_radiance = (
        (y1[..., -1] * e3[..., -1] + y2[..., -1] * e4[..., -1] + cmb[..., -1]) / u1
        + torch.exp(-tauc[None, ..., -1] / u0[..., 0])
    )
    return amean, surface_radiance, fup, fdn


def two_stream_solar_multi(tau_in, w0_in, gt_in, u0s, Rsfc):
    """Solar two-stream for SEVERAL zenith angles sharing one column.

    tau_in/w0_in/gt_in (..., nz) TOA-down; ``u0s`` (nzen,) zenith cosines
    shared by the whole batch; ``Rsfc`` surface albedo (...). The Toon matrix
    depends only on (tau, w0, g, Rsfc), so the scaling, e-coefficients and
    block-PCR elimination are computed once and all zenith right-hand sides
    are swept through them.

    Returns (amean, surface_radiance, fup, fdn) with a LEADING nzen axis:
    amean/fup/fdn (nzen, ..., nz+1), surface_radiance (nzen, ...), TOA solar
    flux normalized to 1.
    """
    u0 = u0s.reshape((u0s.shape[0],) + (1,) * tau_in.ndim)
    return _solar(tau_in, w0_in, gt_in, u0, Rsfc)


def two_stream_solar(tau_in, w0_in, gt_in, u0, Rsfc):
    """Solar two-stream with delta-Eddington scaling (twostream.f90:10-154).

    ``u0``: zenith cosine, a tensor broadcastable against the batch dims.
    Returns (amean, surface_radiance, fup, fdn), edge arrays (..., nz+1).
    """
    u0 = torch.as_tensor(u0, dtype=tau_in.dtype, device=tau_in.device)
    return tuple(x[0] for x in _solar(tau_in, w0_in, gt_in, u0[None, ..., None], Rsfc))


def two_stream_solar_multi_weighted(tau, w0, gt, u0s, Rsfc, zw, wbin, with_amean=True):
    """Multi-zenith solar solve with the zenith- and gauss-weight reductions.

    tau/w0/gt (rows, nz) with rows = groups*nG flattened group-major (in the
    radiate module a group is one (column, bin)); u0s/zw (nzen,); Rsfc (rows,);
    wbin (nG,). Returns (am_w, fup_w, fdn_w), each (groups, nz+1):
    ``sum_z sum_g zw[z] * wbin[g] * X[z, group*nG+g]`` (the weight
    accumulation of clima_radtran_radiate.f90:121-135). am_w is None when
    ``with_amean`` is False.
    """
    nG = wbin.shape[0]
    amean, _, fup, fdn = two_stream_solar_multi(tau, w0, gt, u0s, Rsfc)
    nzen = u0s.shape[0]
    red = lambda x: torch.einsum("zwgk,g,z->wk", x.reshape(nzen, -1, nG, x.shape[-1]), wbin, zw)
    return (red(amean) if with_amean else None), red(fup), red(fdn)


def two_stream_ir(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck):
    """IR hemispheric-mean two-stream (twostream.f90:156-295).

    ``bplanck``: (..., nz+1) Planck function at edges, TOA-down, with
    bplanck[..., -1] the ground value. ``emissivity`` (...).
    Returns (fup, fdn) of shape (..., nz+1).
    """
    u1 = 0.5
    norm = 2.0 * const.pi * u1

    Rsfc = (1.0 - emissivity) if has_hard_surface else torch.zeros_like(emissivity)

    gam1 = 2.0 - w0 * (1.0 + gt)
    gam2 = w0 * (1.0 - gt)
    lam = torch.sqrt(gam1**2 - gam2**2)
    cap_gam = gam2 / (gam1 + lam)
    e1, e2, e3, e4 = _es(lam, cap_gam, tau)

    b_top = bplanck[..., :-1]
    b_bot = bplanck[..., 1:]
    thin = tau <= tau_min
    b0n = torch.where(thin, 0.5 * (b_top + b_bot), b_top)
    b1n = torch.where(thin, torch.zeros_like(tau),
                      (b_bot - b_top) / torch.where(thin, torch.ones_like(tau), tau))

    inv_g = 1.0 / (gam1 + gam2)
    cp0 = norm * (b0n + b1n * inv_g)
    cpb = norm * (b0n + b1n * (tau + inv_g))
    cm0 = norm * (b0n - b1n * inv_g)
    cmb = norm * (b0n + b1n * (tau - inv_g))

    if has_hard_surface:
        Ssfc = emissivity[..., None] * const.pi * bplanck[..., -1:]
    else:
        tau_bot = tau[..., -1:]
        thin_bot = tau_bot <= tau_min
        b1_bot = torch.where(
            thin_bot, torch.zeros_like(tau_bot),
            (bplanck[..., -1:] - bplanck[..., -2:-1])
            / torch.where(thin_bot, torch.ones_like(tau_bot), tau_bot),
        )
        Ssfc = const.pi * (bplanck[..., -1:] + u1 * b1_bot)

    A_ev, B_ev, D_ev, A_od, B_od, D_od = _matrix_rows(e1, e2, e3, e4, Rsfc)
    E_ev, E_od = _rhs_rows(e1, e2, e3, e4, cp0, cpb, cm0, cmb, Rsfc, Ssfc)
    y1, y2 = (y[0] for y in _solve_rows(A_ev, B_ev, D_ev, A_od, B_od, D_od, E_ev[None],
                                        E_od[None]))

    fup = torch.cat([y1[..., :1] * e3[..., :1] - y2[..., :1] * e4[..., :1] + cp0[..., :1],
                     y1 * e1 + y2 * e2 + cpb], -1)
    fdn = torch.cat([torch.zeros_like(tau[..., :1]), y1 * e3 + y2 * e4 + cmb], -1)
    return fup, fdn


def two_stream_ir_weighted(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck, wbin):
    """IR two-stream with the gauss-weight reduction: tau/w0/gt (rows, nz)
    group-major, bplanck (rows, nz+1), emissivity (rows,), wbin (nG,).

    Returns (fup_w, fdn_w), each (groups, nz+1): ``sum_g wbin[g] * X[group*nG+g]``.
    """
    nG = wbin.shape[0]
    fup, fdn = two_stream_ir(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck)
    red = lambda x: torch.einsum("wgk,g->wk", x.reshape(-1, nG, x.shape[-1]), wbin)
    return red(fup), red(fdn)
