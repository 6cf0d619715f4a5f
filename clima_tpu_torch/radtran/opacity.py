"""Opacity assembly: k-tables + continua + particles -> (tau, w0, g) per bin.

Re-implements ``OpticalProperties_compute_opacity`` and ``k_rorr``
(``src/radtran/clima_radtran_types.f90:574-888``) for a batch of columns: the
reference's loop over wavelength bins and its per-layer interpolation loops
become whole-tensor contractions over (columns x bins x gauss x layers).

Input convention matches the reference facade with a leading column axis:
ground-up layer arrays (index 0 = bottom). Output arrays are TOA-down
(index 0 = top), as the reference's result arrays are.
"""

from __future__ import annotations

import warnings

import torch

from .. import constants as const
from ..ops.interp import hat_weights, pdot
from ..ops.rorr import k_aee_mix, k_rorr_mix
from ..ops import rorr_cuda
from ..ops.rorr_cuda import k_rorr_mix_cuda
from ..utils.profiling import span
from .data import OpticalData

__all__ = ["compute_opacity", "set_rorr_pallas_mode"]


def set_rorr_pallas_mode(name: str):
    """The RORR wrapper's (:func:`k_rorr_mix_cuda`) switch, the JAX package's
    name for its choice between the Pallas kernel and XLA. Here the tensor's
    device chooses, the CUDA kernel for a CUDA tensor and the sort twin
    (``ops.rorr.k_rorr_mix``) for a CPU tensor, and the mode only refuses:
    "auto" (the default) nothing, "never" a CUDA tensor (to run the twin on
    the card, call it), "always" a CPU tensor. Past nbin 16 the sort path
    runs whatever the mode, with its warning.
    """
    if name not in ("auto", "never", "always"):
        raise ValueError(name)
    rorr_cuda._MODE = name

# pair keys (lanes x nbin^2) per chunk of the sort path past nbin 16
_SORT_CHUNK_KEYS = 1 << 25


def _tiny(dtype):
    return 1e-300 if dtype == torch.float64 else 1e-37


def _safe_log10(x):
    return torch.log10(torch.clamp(x, min=_tiny(x.dtype)))


def _interp_table_T_log10(temp_grid, table, T):
    """Interpolate log10-xsection rows at temperatures T (B, nz) with clamping.

    Returns log10 values (B, nz, nw). Matches interpolate_Xsection
    (types.f90:890-917): T clamped to the grid range, linear in log10 space.
    Kept in log10 for float32 safety: CIA/continuum terms combine xs ~ 1e-46
    with density products ~ 1e38, both outside float32 range individually.
    """
    return pdot(hat_weights(temp_grid, T), table)


def _ktable_weights(kt, log10P, T):
    """Bilinear hat weights of one k-table at (log10P, T) (B, nz) -> (P*T,
    B*nz): the outer product of its pressure and temperature hat weights."""
    Wp = hat_weights(kt.log10P, log10P)  # (B, nz, P)
    Wt = hat_weights(kt.temp, T)  # (B, nz, T)
    B, nz, P = Wp.shape
    Tn = Wt.shape[-1]
    return (Wp.permute(2, 0, 1)[:, None] * Wt.permute(2, 0, 1)[None]).reshape(P * Tn, B * nz)


def _ktable_contract(kt, WptT, B, nz):
    """One k-table against its weights (:func:`_ktable_weights`) -> k (G, W,
    B, nz), linear units: one (G*W, P*T) @ (P*T, B*nz) matmul, whose output
    is already the RORR kernel's (gauss, lanes) layout."""
    G, P, Tn, Wn = kt.log10k.shape
    tabT = kt.log10k.permute(0, 3, 1, 2).reshape(G * Wn, P * Tn)
    return 10.0 ** pdot(tabT, WptT).reshape(G, Wn, B, nz)


def _interp_ktable(kt, log10P, T):
    """Bilinear k-table interpolation -> k (G, W, B, nz), linear units.

    Matches the clamped 2-D interpolation at types.f90:649-662 as a
    hat-basis contraction (:func:`_ktable_weights`, then
    :func:`_ktable_contract`).
    """
    B, nz = T.shape
    return _ktable_contract(kt, _ktable_weights(kt, log10P, T), B, nz)


def _interp_particle(part, radii_z):
    """Particle optical data at radii (B, nz) -> (w0, qext, gt), each (B, nz, nw).

    Radii outside the table are clamped (interpolate_Particle, :947-983).
    """
    W = hat_weights(part.radii, radii_z)
    return pdot(W, part.w0), pdot(W, part.qext), pdot(W, part.gt)


def _rorr_mix(tau_ks_t, wbin, wbin_e):
    """RORR mix of the species chain (nk, nbin, R) -> (nbin, R).

    nbin alone picks the path, on every device, as in the JAX package
    (``clima_tpu/radtran/opacity.py:185-206``): nbin <= 16 goes through the
    RORR kernel (:func:`k_rorr_mix_cuda`, a sort of each lane's nbin^2 pair
    keys by a group of threads; its plain twin for CPU tensors); past
    nbin=16, the reference's threshold, the sort path :func:`k_rorr_mix`
    runs on the tensors' own device, with the reference's warning, over
    chunks of at most ``_SORT_CHUNK_KEYS`` pair keys (float64 pair tensors of
    the whole radtran batch at nbin 20 would be ~8.4 GB each).
    """
    nk, nbin, R = tau_ks_t.shape
    if nk == 1:
        return tau_ks_t[0]
    if nbin <= 16:
        return k_rorr_mix_cuda(tau_ks_t, wbin, wbin_e)
    warnings.warn(
        f"RORR with nbin={nbin} > 16: using the sort-based k-mixing path, far slower "
        "than the RORR kernel, which takes nbin <= 16 (the reference's threshold). Over "
        "3 species x 25856 lanes (tools/rorr_crossover.py on an NVIDIA H100 80GB HBM3, "
        "700.00 W) the kernel took 0.222 ms at nbin 16, the sort path 10.096 ms at nbin "
        "16 and 16.949 ms at nbin 20 (PERF.md).",
        stacklevel=3,
    )
    return _rorr_sort(tau_ks_t, wbin_e)


def _rorr_sort(tau_ks_t, wbin_e):
    """The sort path :func:`k_rorr_mix` on the kernel's layout, (nk, nbin, R)
    -> (nbin, R), over chunks of at most ``_SORT_CHUNK_KEYS`` pair keys."""
    nk, nbin, R = tau_ks_t.shape
    # lanes are independent: chunking bounds the (lanes, nbin^2) pair tensors.
    # Each chunk is made contiguous, so a lane's result does not depend on the
    # chunk size (on strided lanes the reductions' order follows the batch).
    chunk = max(1, _SORT_CHUNK_KEYS // (nbin * nbin))
    lanes = tau_ks_t.movedim(1, -1)
    return torch.cat([k_rorr_mix(lanes[:, i:i + chunk].contiguous(), wbin_e)
                      for i in range(0, R, chunk)]).movedim(-1, 0)


# compute_opacity's stages, in the order it runs them: each takes the
# TOA-down inputs of _toa_down and what the stages before it made
# (tools/opacity_substages.py times each one on the chain's own inputs; in
# compute_opacity each runs in its span radtran.opacity.<stage> of the
# recorder in utils/profiling.py)

def _toa_down(P, T, densities, dz, pdensities, radii):
    """The ground-up inputs flipped TOA-down, then log10 P and the species
    columns (B, nz, ng)."""
    flip = lambda x: torch.flip(x, dims=[1])
    P, T, densities, dz = flip(P), flip(T), flip(densities), flip(dz)
    if pdensities is not None:
        pdensities = flip(pdensities)
    if radii is not None:
        radii = flip(radii)
    log10P = torch.log10(P)
    cols = densities * dz[..., None]  # (B, nz, ng)
    return P, T, densities, dz, pdensities, radii, log10P, cols


def _kweights(op, log10P, T):
    """Each k-table's hat weights (:func:`_ktable_weights`), in ``op.k``'s order."""
    return [_ktable_weights(kt, log10P, T) for kt in op.k]


def _k_distributions(op, weights, cols):
    """Per-species tau at each gauss point, (nk, G, W, B, nz): each k-table
    against its weights, times the species' columns."""
    B, nz = cols.shape[:2]
    return torch.stack(
        [_ktable_contract(kt, W, B, nz) * cols[:, :, kt.sp_ind] for kt, W in zip(op.k, weights)],
        dim=0)


def _mix(op, tau_ks):
    """k-distribution mixing, (nk, G, W, B, nz) -> tau_kmix (G, W, B, nz)."""
    nk, nbin, nw, B, nz = tau_ks.shape
    if op.kset.k_method == "AdaptiveEquivalentExtinction":
        # declared-but-unimplemented in the reference (types.f90:761-763)
        return k_aee_mix(tau_ks.movedim(1, -1), op.kset.wbin).movedim(-1, 0)
    # RORR (k_rorr, types.f90:780-888)
    mixed = _rorr_mix(tau_ks.reshape(nk, nbin, -1), op.kset.wbin, op.kset.wbin_e)
    return mixed.reshape(nbin, nw, B, nz)


def _rayleigh(op, cols, zeros):
    """Rayleigh scattering optical depth (B, nz, nw)."""
    tausg = zeros
    for xs in op.ray:
        tausg = tausg + xs.xs_0d * cols[:, :, xs.sp_inds[0], None]
    return tausg


def _absorption(op, T, densities, dz, cols, zeros):
    """Continuum absorption (B, nz, nw): CIA + photolysis + the other
    cross-sections + the water continuum. Binary terms (xsection * density *
    density * dz) are accumulated in log10 space: the factors individually
    over/underflow float32."""
    taua = zeros
    for xs in op.cia:
        j, jj = xs.sp_inds
        if xs.dim == 0:
            lgval = _safe_log10(xs.xs_0d)
        else:
            lgval = _interp_table_T_log10(xs.temp, xs.log10_xs, T)
        lgcol = _safe_log10(densities[:, :, j]) + _safe_log10(densities[:, :, jj]) + torch.log10(dz)
        taua = taua + 10.0 ** (lgval + lgcol[..., None])

    for xs in op.pxs + op.axs:
        j = xs.sp_inds[0]
        if xs.dim == 0:
            val = xs.xs_0d
        else:
            val = 10.0 ** _interp_table_T_log10(xs.temp, xs.log10_xs, T)
        taua = taua + val * cols[:, :, j, None]

    if op.cont is not None:
        LH2O = op.cont.LH2O
        lg_h2o = _interp_table_T_log10(op.cont.temp, op.cont.log10_xs_H2O, T)
        lg_for = _interp_table_T_log10(op.cont.temp, op.cont.log10_xs_foreign, T)
        foreign_col = torch.sum(cols, dim=-1) - cols[:, :, LH2O]
        lg_n_h2o = _safe_log10(densities[:, :, LH2O])
        taua = taua + 10.0 ** (lg_h2o + (lg_n_h2o + _safe_log10(cols[:, :, LH2O]))[..., None])
        taua = taua + 10.0 ** (lg_for + (lg_n_h2o + _safe_log10(foreign_col))[..., None])
    return taua


def _custom_properties(custom, P, dz, zeros):
    """Custom optical properties (types.f90:429-572) -> (tauc, tausc, g0c),
    each (B, nz, nw); without ``custom``, tiny values."""
    if custom is not None:
        W = hat_weights(custom["log10P"], torch.log10(P * 1.0e6))
        tauc = pdot(W, custom["dtau_dz"]) * dz[..., None]
        w0c = pdot(W, custom["w0"])
        g0c = pdot(W, custom["g0"])
    else:
        tauc = w0c = g0c = torch.full(zeros.shape, _tiny(zeros.dtype), dtype=zeros.dtype,
                                      device=zeros.device)
    return tauc, w0c * tauc, g0c


def _particles(op, pdensities, radii, dz, zeros):
    """Particle extinction, scattering and asymmetry numerator (taup, tausp,
    gt_num), each (B, nz, nw); zeros without particles."""
    taup = tausp = gt_num = zeros
    if op.part and pdensities is not None:
        for part in op.part:
            j = part.p_ind
            w0p, qextp, gtp = _interp_particle(part, radii[:, :, j])
            taup_1 = qextp * const.pi * (radii[:, :, j] ** 2 * pdensities[:, :, j] * dz)[..., None]
            tausp_1 = w0p * taup_1
            taup = taup + taup_1
            tausp = tausp + tausp_1
            gt_num = gt_num + gtp * tausp_1
    return taup, tausp, gt_num


def _combine(op, tau_kmix, tausg, taua, tauc, tausc, g0c, taup, tausp, gt_num):
    """The scattering clamp and asymmetry, then the combine per gauss point
    into compute_opacity's TOA-down dict."""
    scat_tot = torch.clamp(tausp + tausg + tausc, min=const.tau_min)
    gt = gt_num / scat_tot + g0c * tausc / scat_tot
    gt = torch.clamp(gt, max=const.max_gt)

    # (B, W, G, nz)
    tau_cont = (tausg + taua + taup + tauc).transpose(1, 2)  # (B, W, nz)
    tausum = (tausg + tausp + tausc).transpose(1, 2)  # (B, W, nz) scattering part
    tau = (tau_cont[:, :, None, :] + tau_kmix.permute(2, 1, 0, 3)).contiguous()
    w0 = torch.where(
        tau <= const.tau_min,
        torch.zeros((), dtype=tau.dtype, device=tau.device),
        torch.clamp(tausum[:, :, None, :] / tau, max=const.max_w0),
    )
    tau_band = torch.sum(tau * op.kset.wbin[:, None], dim=2)  # (B, W, nz)

    return dict(tau=tau, w0=w0, g=gt.transpose(1, 2), tau_band=tau_band)


def compute_opacity(op: OpticalData, P, T, densities, dz, pdensities=None, radii=None,
                    custom=None):
    """Assemble total optical properties for a batch of columns.

    Parameters (ground-up, layer index 0 = bottom, leading column axis B):
      P: (B, nz) bars;  T: (B, nz);  densities: (B, nz, ng) molecules/cm^3;
      dz: (B, nz) cm;  pdensities/radii: (B, nz, np);  custom: optional dict
      with keys log10P (nPc, ascending, log10 dynes/cm^2), dtau_dz/w0/g0
      (nPc, nw).
    ``op`` holds tables on the inputs' device and dtype.

    Returns dict with TOA-down arrays:
      tau (B, nw, nbin, nz), w0 (B, nw, nbin, nz), g (B, nw, nz),
      tau_band (B, nw, nz).
    """
    with span("radtran.opacity"):
        with span("radtran.opacity.prepare"):
            P, T, densities, dz, pdensities, radii, log10P, cols = _toa_down(
                P, T, densities, dz, pdensities, radii)
            zeros = torch.zeros(T.shape + (op.nw,), dtype=T.dtype, device=T.device)
        with span("radtran.opacity.kweights"):
            weights = _kweights(op, log10P, T)
        with span("radtran.opacity.kdist"):
            tau_ks = _k_distributions(op, weights, cols)
        with span("radtran.opacity.mix"):
            tau_kmix = _mix(op, tau_ks)
        with span("radtran.opacity.rayleigh"):
            tausg = _rayleigh(op, cols, zeros)
        with span("radtran.opacity.absorption"):
            taua = _absorption(op, T, densities, dz, cols, zeros)
        with span("radtran.opacity.custom"):
            tauc, tausc, g0c = _custom_properties(custom, P, dz, zeros)
        with span("radtran.opacity.particles"):
            taup, tausp, gt_num = _particles(op, pdensities, radii, dz, zeros)
        with span("radtran.opacity.combine"):
            return _combine(op, tau_kmix, tausg, taua, tauc, tausc, g0c, taup, tausp, gt_num)
