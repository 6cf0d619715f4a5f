"""RORR k-mixing chain: CUDA kernel (``csrc/rorr.cu``), its dispatch, and
plain models of the kernel's schedule and of the rank form.

Replaces the Pallas TPU kernel
``clima_tpu/ops/pallas_rorr.py::k_rorr_mix_pallas_t``. Per lane and species
pair the kernel forms the nbin^2 pair keys once, sorts them as composites
(key bits, pair index) with a bitonic network run by a group of G threads,
scans the pair weights in sorted order for each pair's window and evaluates
the cumulative integral at the master edges, the sort twin's own order and
rebin (:func:`.rorr.k_rorr_mix`). :func:`k_rorr_mix_cuda` runs that twin for
tensors on the CPU and launches the kernel for tensors on a CUDA device;
there is no fallback between the two. ``k_rorr_mix_cuda.launches`` counts its
kernel launches.

What bounds the kernel on an H100 and what its design does about it is
described at the top of ``csrc/rorr.cu``: the sort's compares, selects and
shuffles (operations), the running mix on chip across the species chain.
nbin 8 and 16 are compiled with nbin fixed; any other nbin up to 16 runs an
instance with nbin read at run time, its pair count padded to a power of two.

:func:`mix_pair_sorted_ref` runs the kernel's schedule (instance choice,
padding, network, scans and the rebin at the edges' owners) in plain
PyTorch with the group's threads as a tensor axis; it is for tests only.
:func:`mix_pair_rank_ref` is the JAX package's rank form
(``pallas_rorr.mix_pair_rank_ref``) in plain PyTorch, kept for its
tie-handling tests.
"""

from __future__ import annotations

import torch

from .cuda_build import load_library
from .rorr import k_rorr_mix, make_wxy

__all__ = ["k_rorr_mix_cuda", "mix_pair_sorted_ref", "mix_pair_rank_ref"]

_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
# the kernel's instances (csrc/rorr.cu, dispatch): (largest nbin, padded pair
# count NP, threads per lane G), the first whose nbin fits
_INSTANCES = ((4, 16, 4), (8, 64, 8), (16, 256, 32))


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
    """Rank-form RORR pair mix on rows: (R, nbin) x (R, nbin) -> (R, nbin),
    the counterpart of the JAX package's ``pallas_rorr.mix_pair_rank_ref``
    (keys[p] = a[p % nbin] + b[p // nbin], each window from the weighted rank
    with the index tie-break; nbin^4 compares).

    ``wxy`` (nbin^2,) pair weights wxy[p] = wbin[p % nbin] * wbin[p // nbin];
    ``wbin_e`` (nbin+1,) master edges; both tensors in the rows' dtype.
    """
    return _mix_one_rank(a_rows.T, b_rows.T, wxy, wbin_e).T


def _lt(xb, xp, yb, yp):
    """Composite order (key bits, pair index), lexicographic."""
    return (xb < yb) | ((xb == yb) & (xp < yp))


def mix_pair_sorted_ref(a_rows, b_rows, wxy, wbin_e):
    """The kernel's schedule on rows: (R, nbin) x (R, nbin) -> (R, nbin).

    Same arguments as :func:`mix_pair_rank_ref`. Each lane's pairs lie on a
    (G, E) grid, thread t holding sorted positions t * E .. t * E + E - 1;
    the bitonic network, the scans and the rebin at the edges' owners run in
    the kernel's order of operations (``csrc/rorr.cu``), except that the
    card fuses each key * weight product into its sum.
    """
    R, nbin = a_rows.shape
    _, NP, G = next(inst for inst in _INSTANCES if nbin <= inst[0])
    E, npair = NP // G, nbin * nbin
    dtype, device = a_rows.dtype, a_rows.device
    t = torch.arange(G, device=device)

    # 1. composites: p = i * nbin + j, key = a[i] + b[j]; pads sort last
    keys = (a_rows[:, :, None] + b_rows[:, None, :]).reshape(R, npair)
    bits = keys.view(_BITS[dtype]).to(torch.int64)
    pad = torch.iinfo(_BITS[dtype]).max
    bits = torch.cat([bits, torch.full((R, NP - npair), pad, device=device)], 1)
    idx = torch.arange(NP, device=device).expand(R, NP)
    xb, xp = bits.reshape(R, G, E).clone(), idx.reshape(R, G, E).clone()

    # 2. bitonic network
    for lk in range(1, NP.bit_length()):
        k = 1 << lk
        for lj in range(lk - 1, -1, -1):
            j = 1 << lj
            if j >= E:  # partner thread t ^ m, same slot (a shuffle)
                m = j // E
                keep_min = (((t & m) == 0) == (((t * E) & k) == 0))[None, :, None]
                yb, yp = xb[:, t ^ m], xp[:, t ^ m]
                take = _lt(yb, yp, xb, xp) == keep_min
                xb, xp = torch.where(take, yb, xb), torch.where(take, yp, xp)
            else:  # partner slot q ^ j in the same thread
                q = torch.tensor([s for s in range(E) if s ^ j > s], device=device)
                q2 = q ^ j
                asc = (((t[:, None] * E + q[None, :]) & k) == 0)[None]
                lb, lp, hb, hp = xb[..., q], xp[..., q], xb[..., q2], xp[..., q2]
                swap = _lt(hb, hp, lb, lp) == asc
                xb[..., q], xp[..., q] = torch.where(swap, hb, lb), torch.where(swap, hp, lp)
                xb[..., q2], xp[..., q2] = torch.where(swap, lb, hb), torch.where(swap, lp, hp)

    # 3. weights and key * weight in sorted order, scanned: sequentially in a
    # thread, then across the group by a Hillis-Steele scan of the totals
    key = xb.to(_BITS[dtype]).view(dtype) if dtype == torch.float32 else xb.view(dtype)
    key = torch.where(xp < npair, key, torch.zeros((), dtype=dtype))
    w = torch.cat([wxy, torch.zeros(NP - npair, dtype=dtype, device=device)])[xp]
    lower = torch.empty_like(w)
    run = torch.zeros((R, G), dtype=dtype, device=device)
    run_kw = torch.zeros((R, G), dtype=dtype, device=device)
    for q in range(E):
        lower[..., q] = run
        run = run + w[..., q]
        run_kw = run_kw + key[..., q] * w[..., q]

    def exclusive_scan(v):
        for ld in range(G.bit_length() - 1):
            d = 1 << ld
            v = torch.where(t >= d, v + torch.cat([v[:, :d], v[:, :-d]], 1), v)
        return torch.cat([torch.zeros((R, 1), dtype=dtype, device=device), v[:, :-1]], 1)

    off, below = exclusive_scan(run), exclusive_scan(run_kw)
    lower = lower + off[..., None]

    # 4. F at each master edge from its owner, the last thread whose first
    # pair starts at or below the edge; mix = diff(F) / diff(edges)
    rows = torch.arange(R, device=device)
    F = []
    for e in wbin_e:
        owner = torch.where(off <= e, t, -1).amax(1).clamp(min=0)
        Fe = below[rows, owner]
        for q in range(E):
            lo, wq = lower[rows, owner, q], w[rows, owner, q]
            Fe = Fe + key[rows, owner, q] * torch.minimum(torch.clamp(e - lo, min=0.0), wq)
        F.append(Fe)
    F = torch.stack(F, 1)
    return (F[:, 1:] - F[:, :-1]) / torch.diff(wbin_e)


def k_rorr_mix_cuda(tau_ks_t, wbin, wbin_e):
    """RORR mix of the whole species chain on the kernel's layout.

    ``tau_ks_t``: (nk, nbin, R), the flattened batch R last. ``wbin`` (nbin,)
    and ``wbin_e`` (nbin+1,) on the same device. Returns (nbin, R).
    """
    if tau_ks_t.device.type == "cpu":
        # contiguous lanes: on a strided view the CPU reductions' order, and
        # so a lane's last bits, would follow the number of lanes
        return k_rorr_mix(tau_ks_t.movedim(1, -1).contiguous(), wbin_e).movedim(-1, 0)
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
