"""Random-Overlap-Resort-Rebin (RORR) k-distribution mixing, plain PyTorch.

Reference: ``k_rorr`` at ``src/radtran/clima_radtran_types.f90:780-888``. Per
(layer, bin) the reference forms the nbin^2 pairwise sums of the running mixed
k-optical-depth with the next species, sorts them (mrgrnk), accumulates the
sorted pair weights into bin edges, and conservatively rebins back onto the
nbin master weight grid.

Here the sort is one stable ``torch.sort`` over the last axis of the whole
(..., nbin^2) batch, and the conservative rebin is a clipped reduction at
each master edge. This is the twin of the CUDA kernel in :mod:`.rorr_cuda`.
"""

from __future__ import annotations

import torch

__all__ = ["k_rorr_mix", "k_aee_mix", "make_wxy"]


def make_wxy(wbin):
    """Pair weights wxy[i*nbin+j] = wbin[i]*wbin[j] (types_create.f90:215-219)."""
    return (wbin[:, None] * wbin[None, :]).reshape(-1)


def _mix_pair(tau_mixed, tau_next, wxy, wbin_e):
    """One RORR combine step: mix (..., nbin) with (..., nbin) -> (..., nbin).

    The conservative rebin onto the master edges is evaluated as
    ``F(e) = sum_k tau_k * clip(e - lower_k, 0, w_k)`` at each edge.
    """
    nbin = tau_mixed.shape[-1]
    # pairwise sums, i (existing mix) slow axis, j (new species) fast axis
    tau_xy = (tau_mixed[..., :, None] + tau_next[..., None, :]).reshape(
        tau_mixed.shape[:-1] + (nbin * nbin,)
    )
    tau_sorted, order = torch.sort(tau_xy, dim=-1, stable=True)
    w_sorted = wxy[order]

    # cumulative lower edge of each sorted source bin
    lower = torch.cumsum(w_sorted, dim=-1) - w_sorted

    # cumulative integral F(e) of the piecewise-constant tau over weight
    # space, evaluated at the nbin+1 master edges
    F = torch.stack([
        torch.sum(tau_sorted * torch.minimum(torch.clamp(e - lower, min=0.0), w_sorted), dim=-1)
        for e in wbin_e
    ], dim=-1)
    return torch.diff(F, dim=-1) / torch.diff(wbin_e)


def k_rorr_mix(tau_ks, wbin_e):
    """Mix per-species k-term optical depths into one k-distribution.

    ``tau_ks``: (nk, ..., nbin) optical depth of each k-species at each gauss
    point (already multiplied by the species column). ``wbin_e``: (nbin+1,)
    master weight edges, on the same device. Returns the mixed (..., nbin).
    """
    wxy = make_wxy(torch.diff(wbin_e))
    mixed = tau_ks[0]
    for i in range(1, tau_ks.shape[0]):
        mixed = _mix_pair(mixed, tau_ks[i], wxy, wbin_e)
    return mixed


def k_aee_mix(tau_ks, wbin):
    """Adaptive-equivalent-extinction mixing of k-species optical depths.

    The reference declares this k-method but leaves it unimplemented
    (``clima_radtran_types.f90:80-82``, errors at ``:761-763``). Per (bin,
    layer), the species with the largest band-mean (grey) optical depth keeps
    its full k-distribution and all other species contribute their grey
    optical depth (Amundsen et al. 2017); the weighted band mean is preserved
    exactly.

    ``tau_ks``: (nk, ..., nbin); ``wbin``: (nbin,). Returns (..., nbin).
    """
    tau_grey = torch.sum(tau_ks * wbin, dim=-1)  # (nk, ...)
    total_grey = torch.sum(tau_grey, dim=0)
    idx_major = torch.argmax(tau_grey, dim=0)  # (...)
    tau_major = torch.take_along_dim(tau_ks, idx_major[None, ..., None], dim=0)[0]
    grey_major = torch.take_along_dim(tau_grey, idx_major[None], dim=0)[0]
    return tau_major + (total_grey - grey_major)[..., None]
