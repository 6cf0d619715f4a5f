"""Per-channel radiative transfer: two-stream over bins x gauss x zenith.

Re-implements ``radiate`` (``src/radtran/clima_radtran_radiate.f90:7-196``)
for a batch of columns: the reference's bin loop and nested gauss/zenith
loops become one weight-fused two-stream call over all (column, bin, gauss)
rows. Output ordering matches the reference: flux arrays are ground-up
(index 0 = surface), with a leading column axis.
"""

from __future__ import annotations

import torch

from .. import constants as const
from ..ops.twostream_cuda import (
    two_stream_ir_weighted_cuda,
    two_stream_solar_multi_weighted_cuda,
)
from ..physics.eqns import planck_fcn
from ..utils.profiling import span

__all__ = ["radiate_ir", "radiate_solar", "integrate_fluxes"]


def _rows(x, nw, nG):
    """(B, nw[, 1], ...) -> (B*nw*nG, ...) rows, (column, bin, gauss)-major."""
    B = x.shape[0]
    return x.expand((B, nw, nG) + x.shape[3:]).reshape(B * nw * nG, *x.shape[3:])


def _ground_up(x):
    """(B, nw, n) TOA-down -> (B, n, nw) ground-up."""
    return torch.flip(x, dims=[-1]).transpose(1, 2)


def radiate_ir(channel_slice, freq_master, wbin, opr, surface_emissivity,
               has_hard_surface, ir_tau_min, T_surface, T):
    """IR channel RT for a batch of columns.

    ``channel_slice``: (ind_start, ind_end) ints into the master grid.
    ``opr``: dict from compute_opacity (TOA-down, leading column axis B).
    ``T_surface`` (B,); ``T`` (B, nz) ground-up.
    Returns dict(fup_a, fdn_a, amean (B, nz+1, nw) ground-up, tau_band (B, nz, nw)).
    """
    with span("radtran.radiate_ir"):
        with span("radtran.radiate_ir.prepare"):
            i0, i1 = channel_slice
            tau = opr["tau"][:, i0 : i1 + 1]  # (B, nw, G, nz)
            B, nw, nG, nz = tau.shape

            freq = freq_master[i0 : i1 + 2]
            avg_freq = 0.5 * (freq[:-1] + freq[1:])  # (nw,)
            # bplanck (B, nw, nz+1): TOA-down layer temps then surface
            bplanck = torch.cat([
                planck_fcn(avg_freq[None, :, None], torch.flip(T, dims=[1])[:, None, :]),
                planck_fcn(avg_freq[None, :, None], T_surface[:, None, None]),
            ], dim=-1)
            rows = (_rows(tau, nw, nG),
                    _rows(opr["w0"][:, i0 : i1 + 1], nw, nG),
                    _rows(opr["g"][:, i0 : i1 + 1, None, :], nw, nG),
                    _rows(surface_emissivity[None, :, None].expand(B, nw, 1), nw, nG))
            planck_rows = _rows(bplanck[:, :, None, :], nw, nG)

        with span("radtran.radiate_ir.kernel"):
            fup_w, fdn_w = two_stream_ir_weighted_cuda(
                *rows, has_hard_surface, ir_tau_min, planck_rows, wbin,
            )  # (B*nw, nz+1) TOA-down

        with span("radtran.radiate_ir.finish"):
            return dict(
                fup_a=_ground_up(fup_w.reshape(B, nw, nz + 1)),
                fdn_a=_ground_up(fdn_w.reshape(B, nw, nz + 1)),
                amean=torch.zeros((B, nz + 1, nw), dtype=tau.dtype, device=tau.device),
                tau_band=_ground_up(opr["tau_band"][:, i0 : i1 + 1]),
            )


def radiate_solar(channel_slice, freq_master, wavl_master, wbin, opr,
                  surface_albedo, diurnal_fac, photons_sol, zenith_u,
                  zenith_weights, compute_amean=True):
    """Solar channel RT for a batch of columns.

    ``photons_sol``: (nw_sol,) mW/m^2/Hz (already photon_scale_factor-scaled).
    ``zenith_u``/``zenith_weights``: (n_zen,). ``surface_albedo`` (nw_sol,).
    Returns dict(fup_a, fdn_a, amean (B, nz+1, nw_sol) ground-up, tau_band).
    """
    with span("radtran.radiate_solar"):
        with span("radtran.radiate_solar.prepare"):
            i0, i1 = channel_slice
            tau = opr["tau"][:, i0 : i1 + 1]  # (B, nw, G, nz)
            B, nw, nG, nz = tau.shape
            rows = (_rows(tau, nw, nG),
                    _rows(opr["w0"][:, i0 : i1 + 1], nw, nG),
                    _rows(opr["g"][:, i0 : i1 + 1, None, :], nw, nG))
            albedo_rows = _rows(surface_albedo[None, :, None].expand(B, nw, 1), nw, nG)

        # all zenith angles share each column's optical properties: one
        # multi-right-hand-side solve per row, with the zenith and gauss
        # weights applied inside it
        with span("radtran.radiate_solar.kernel"):
            am_w, fup_w, fdn_w = two_stream_solar_multi_weighted_cuda(
                *rows, zenith_u, albedo_rows, zenith_weights, wbin, with_amean=compute_amean,
            )  # each (B*nw, nz+1) TOA-down; am_w is None when compute_amean=False

        with span("radtran.radiate_solar.finish"):
            # scale by stellar flux (mW/m2/Hz) and diurnal factor
            scale = (photons_sol * diurnal_fac)[None, :, None]
            fup_w = fup_w.reshape(B, nw, nz + 1) * scale
            fdn_w = fdn_w.reshape(B, nw, nz + 1) * scale

            if compute_amean:
                am_w = am_w.reshape(B, nw, nz + 1) * scale
                # amean -> photons/cm^2/s (radiate.f90:167-179)
                freq = freq_master[i0 : i1 + 2]
                wavl = wavl_master[i0 : i1 + 2]
                avg_freq = 0.5 * (freq[:-1] + freq[1:])
                avg_wavl = 1.0e9 * const.c_light / avg_freq  # nm
                am_w = am_w * (avg_freq / avg_wavl)[:, None]
                am_w = am_w * (avg_wavl / (const.plank * const.c_light * 1.0e16)
                               * (wavl[1:] - wavl[:-1]))[:, None]
                amean_out = _ground_up(am_w)
            else:
                amean_out = torch.zeros((B, nz + 1, nw), dtype=tau.dtype, device=tau.device)

            return dict(
                fup_a=_ground_up(fup_w),
                fdn_a=_ground_up(fdn_w),
                amean=amean_out,
                tau_band=_ground_up(opr["tau_band"][:, i0 : i1 + 1]),
            )


@span("radtran.integrate")
def integrate_fluxes(fup_a, fdn_a, freq_channel):
    """Frequency-integrate per-bin fluxes -> mW/m^2 (radiate.f90:182-192).

    fup_a/fdn_a (..., nz+1, nw); returns fup_n, fdn_n (..., nz+1)."""
    dfreq = freq_channel[:-1] - freq_channel[1:]  # (nw,)
    return torch.sum(fup_a * dfreq, dim=-1), torch.sum(fdn_a * dfreq, dim=-1)
