"""RORR k-mixing chain: CUDA kernel (``csrc/rorr.cu``), its dispatch, and the
rank-form reference.

Replaces the Pallas TPU kernel
``clima_tpu/ops/pallas_rorr.py::k_rorr_mix_pallas_t``. The kernel is
sort-free: each pair's rebin window is its weighted rank, with the exact
stable-sort tie-break ``ikey_k < ikey_p + (p > k)`` on the keys' bit
patterns. :func:`k_rorr_mix_cuda` runs the plain PyTorch twin (the sort path
:func:`.rorr.k_rorr_mix`, the JAX package's XLA math) for tensors on the CPU
and launches the kernel for tensors on a CUDA device; there is no fallback
between the two. ``k_rorr_mix_cuda.launches`` counts its kernel launches.

What bounds the kernel on an H100 and what its design does about it is
described at the top of ``csrc/rorr.cu``: one thread per lane, the whole
species chain in registers, nbin^4 integer compares per lane and species
pair (compute bound). nbin 8 and 16 are compiled with nbin fixed; any other
nbin up to 16 runs the same kernel with nbin read at run time.

:func:`mix_pair_rank_ref` is the rank form in plain PyTorch, the same
arithmetic as the kernel, kept for the tie-handling tests.
"""

from __future__ import annotations

import torch

from .cuda_build import load_library
from .rorr import k_rorr_mix, make_wxy

__all__ = ["k_rorr_mix_cuda", "mix_pair_rank_ref"]

_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _mix_one_rank(a, b, wxy, wbin_e):
    """One rank-form pair mix on the transposed layout: (nbin, L) x (nbin, L).

    keys[p] = a[p % nbin] + b[p // nbin] with pair weight wxy[p]; each pair's
    lower cumulative-weight edge is its weighted rank with the index
    tie-break, then overlap sums rebin onto the master edges.
    """
    nbin = a.shape[0]
    npair = nbin * nbin
    keys = (a[None, :, :] + b[:, None, :]).reshape(npair, -1)  # p = (p // nbin, p % nbin)
    ikeys = keys.view(_BITS[keys.dtype])
    pidx = torch.arange(npair, device=keys.device)[:, None]
    lower = torch.zeros_like(keys)
    for k in range(npair):
        tgt = torch.where(pidx > k, ikeys + 1, ikeys)
        lower = lower + torch.where(ikeys[k : k + 1] < tgt, wxy[k], torch.zeros_like(wxy[k]))
    upper = lower + wxy[:, None]
    cols = []
    for j in range(nbin):
        e_lo, e_hi = wbin_e[j], wbin_e[j + 1]
        ov = torch.clamp(torch.minimum(upper, e_hi) - torch.maximum(lower, e_lo), min=0.0)
        cols.append(torch.sum(keys * ov, dim=0) * (1.0 / (e_hi - e_lo)))
    return torch.stack(cols, dim=0)


def mix_pair_rank_ref(a_rows, b_rows, wxy, wbin_e):
    """Rank-form RORR pair mix on rows: (R, nbin) x (R, nbin) -> (R, nbin).

    ``wxy`` (nbin^2,) pair weights wxy[p] = wbin[p % nbin] * wbin[p // nbin];
    ``wbin_e`` (nbin+1,) master edges; both tensors in the rows' dtype.
    """
    return _mix_one_rank(a_rows.T, b_rows.T, wxy, wbin_e).T


def k_rorr_mix_cuda(tau_ks_t, wbin, wbin_e):
    """RORR mix of the whole species chain on the kernel's layout.

    ``tau_ks_t``: (nk, nbin, R), the flattened batch R last. ``wbin`` (nbin,)
    and ``wbin_e`` (nbin+1,) on the same device. Returns (nbin, R).
    """
    if tau_ks_t.device.type == "cpu":
        return k_rorr_mix(tau_ks_t.movedim(1, -1), wbin_e).movedim(-1, 0)
    if tau_ks_t.device.type != "cuda":
        raise ValueError(f"no RORR kernel for device {tau_ks_t.device}")
    nk, nbin, R = tau_ks_t.shape
    dtype, device = tau_ks_t.dtype, tau_ks_t.device
    if dtype not in _BITS:
        raise ValueError(f"the RORR kernel takes float32 or float64, not {dtype}")
    if not 1 <= nbin <= 16:
        raise ValueError(f"the RORR kernel takes nbin 1..16, not {nbin}")
    if not tau_ks_t.is_contiguous():
        raise ValueError("tau_ks_t must be contiguous")
    wxy = make_wxy(wbin).to(device=device, dtype=dtype).contiguous()
    edges = wbin_e.to(device=device, dtype=dtype).contiguous()
    out = torch.empty((nbin, R), dtype=dtype, device=device)
    fn = load_library("rorr")["clima_rorr_chain"]
    status = fn(int(dtype == torch.float64), nbin, nk, R, tau_ks_t.data_ptr(),
                wxy.data_ptr(), edges.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"RORR kernel launch failed: error {status}")
    k_rorr_mix_cuda.launches += 1
    return out


k_rorr_mix_cuda.launches = 0
