"""Two-stream solves: CUDA kernels (``csrc/twostream.cu``) and their dispatch.

Replaces the five Pallas TPU kernels of ``clima_tpu/ops/pallas_twostream.py``:
the weight-fused ``two_stream_ir_weighted_pallas`` and
``two_stream_solar_multi_weighted_pallas`` (the radiate module's path), and
the unreduced ``two_stream_ir_pallas``, ``two_stream_solar_multi_pallas`` and
``two_stream_solar_pallas``, which the JAX package reaches through its
dispatchers ``two_stream_{ir,solar_multi,solar}_auto``; the wrappers of the
unreduced kernels carry those names and signatures here. Each wrapper runs
the plain PyTorch twin (:mod:`.twostream`, the same math as the JAX package's
XLA path, solved by block PCR) for tensors on the CPU, and launches the kernel
for tensors on a CUDA device; there is no fallback between the two.

What bounds the kernels on an H100, and what the designs do about it, is
described in ``csrc/twostream.cu``. Four kernels serve the five wrappers;
each runs a 2x2-block Thomas elimination down each column and back, in two
passes, the back substitution fused with the edge fluxes.
``ir_weighted_kernel`` (#1) gives each (column, bin, gauss) row a thread,
reads its inputs through per-warp tiles and sums each gauss group in shared
memory in a fixed order, with no atomics, so the per-row fluxes never reach
device memory; with one gauss point of weight 1 it is also the unreduced IR
solve (#4). ``solar_weighted_kernel`` (#2) gives each (row, zenith) pair a
thread, so it takes any number of zenith angles, and sums zeniths and gauss
points in the same way. ``solar_rows_kernel`` (#5) runs that solve
unreduced, any number of zenith cosines shared by all rows in one launch,
and writes each pair's fluxes out through per-warp staging;
``solar_single_kernel`` (#6) does the same with one cosine per row, its
inputs read through per-warp tiles as #1 reads them.
:func:`ir_weighted_schedule_ref`, :func:`ir_rows_schedule_ref`,
:func:`solar_weighted_schedule_ref` and :func:`solar_rows_schedule_ref` are
plain models of the kernels' schedules, for the tests.

``launches`` on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import torch

from . import twostream as ts
from .. import constants as const
from .cuda_build import load_library

__all__ = ["two_stream_ir_weighted_cuda", "two_stream_solar_multi_weighted_cuda",
           "two_stream_ir_auto", "two_stream_solar_multi_auto", "two_stream_solar_auto",
           "ir_weighted_schedule_ref", "ir_rows_schedule_ref", "solar_weighted_schedule_ref",
           "solar_rows_schedule_ref"]


def _solar_max_group(is_f64, with_amean):
    """The weighted solar kernel's largest nG * nzen (threads) per launch on
    the current device, which its registers bound."""
    n = load_library("twostream")["clima_twostream_solar_max_group"](int(is_f64),
                                                                    int(with_amean))
    if n <= 0:
        raise RuntimeError(f"cannot read the solar kernel's attributes: CUDA error {-n}")
    return n


def _check(tensors, dtype, device):
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernels take float32 or float64, not {dtype}")


def _launch(solar, with_amean, tau, w0, gt, surf, bpl, u0s, zw, wbin, hard, tau_min):
    """The weighted kernels; IR with ``wbin`` None is the unreduced IR solve
    (outputs (rows, nz+1))."""
    rows, nz = tau.shape
    nG = 1 if wbin is None else wbin.shape[0]
    nzen = u0s.shape[0] if solar else 1
    if w0.shape != tau.shape or gt.shape != tau.shape or surf.shape != (rows,):
        raise ValueError("tau/w0/gt must be (rows, nz) and the surface term (rows,)")
    if (bpl is not None and bpl.shape != (rows, nz + 1)) or (solar and zw.shape != u0s.shape):
        raise ValueError("bplanck must be (rows, nz+1) and zw match u0s")
    if not (1 <= nG <= 1024) or rows % nG:
        raise ValueError(f"rows ({rows}) must be whole gauss groups of 1..1024 (nG={nG})")
    kw = dict(dtype=tau.dtype, device=tau.device)
    # IR: (nz, q0 q1 p0 p1, rows); solar: q (nz, 2, rows), tauc (nz, rows)
    # and p (nz, 2, rows * nzen)
    scratch = torch.empty(nz * rows * (3 + 2 * nzen) if solar else (nz, 4, rows), **kw)
    outs = [torch.empty((rows // nG, nz + 1), **kw) for _ in range(3 if with_amean else 2)]
    am = outs[2].data_ptr() if with_amean else None
    fn = load_library("twostream")["clima_twostream_weighted"]
    status = fn(int(tau.dtype == torch.float64), int(solar), int(with_amean),
                tau.data_ptr(), w0.data_ptr(), gt.data_ptr(), surf.data_ptr(),
                bpl.data_ptr() if bpl is not None else None,
                u0s.data_ptr() if solar else None, zw.data_ptr() if solar else None, nzen,
                wbin.data_ptr() if wbin is not None else None, nG, rows, nz, int(hard),
                float(tau_min),
                scratch.data_ptr(), am, outs[0].data_ptr(), outs[1].data_ptr(),
                torch.cuda.current_stream(tau.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"two-stream kernel launch failed: CUDA error {status}")
    return (outs[2] if with_amean else None), outs[0], outs[1]


def two_stream_ir_weighted_cuda(tau, w0, gt, emissivity, has_hard_surface, tau_min,
                                bplanck, wbin):
    """IR two-stream with the gauss-weight reduction fused.

    tau/w0/gt (rows, nz) group-major (rows = groups*nG), emissivity (rows,),
    bplanck (rows, nz+1), wbin (nG,). Returns (fup_w, fdn_w), each
    (groups, nz+1), TOA-down. On the card a gauss group must fit one block of
    the kernel. Twin: :func:`.twostream.two_stream_ir_weighted`; plain model of
    the kernel's schedule: :func:`ir_weighted_schedule_ref`.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_ir_weighted(tau, w0, gt, emissivity, has_hard_surface,
                                         tau_min, bplanck, wbin)
    if tau.device.type != "cuda":
        raise ValueError(f"no two-stream kernel for device {tau.device}")
    _check(dict(tau=tau, w0=w0, gt=gt, emissivity=emissivity, bplanck=bplanck, wbin=wbin),
           tau.dtype, tau.device)
    _, fup, fdn = _launch(False, False, tau, w0, gt, emissivity, bplanck, None, None, wbin,
                          has_hard_surface, tau_min)
    two_stream_ir_weighted_cuda.launches += 1
    return fup, fdn


two_stream_ir_weighted_cuda.launches = 0


def two_stream_solar_multi_weighted_cuda(tau, w0, gt, u0s, Rsfc, zw, wbin, with_amean=True):
    """Multi-zenith solar two-stream with the zenith- and gauss-weight
    reductions fused.

    tau/w0/gt (rows, nz) group-major, u0s/zw (nzen,), Rsfc (rows,), wbin
    (nG,). Returns (am_w, fup_w, fdn_w), each (groups, nz+1), TOA-down;
    am_w is None when ``with_amean`` is False (the kernel then skips it).
    Any number of zenith angles: one launch takes nG * nzen threads per gauss
    group up to the kernel's block size on the device (at most 1024); past
    that, the zeniths run in groups whose weighted outputs are summed.
    Twin: :func:`.twostream.two_stream_solar_multi_weighted`; plain model of
    the kernel's schedule: :func:`solar_weighted_schedule_ref`.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_solar_multi_weighted(tau, w0, gt, u0s, Rsfc, zw, wbin,
                                                  with_amean=with_amean)
    if tau.device.type != "cuda":
        raise ValueError(f"no two-stream kernel for device {tau.device}")
    _check(dict(tau=tau, w0=w0, gt=gt, u0s=u0s, Rsfc=Rsfc, zw=zw, wbin=wbin),
           tau.dtype, tau.device)
    nG = wbin.shape[0]
    max_group = _solar_max_group(tau.dtype == torch.float64, with_amean)
    if nG > max_group:
        raise ValueError(f"a gauss group of {nG} rows exceeds the solar kernel's block "
                         f"({max_group} threads on this device)")

    def launch(u0_group, zw_group):
        out = _launch(True, with_amean, tau, w0, gt, Rsfc, None, u0_group, zw_group, wbin,
                      False, 0.0)
        two_stream_solar_multi_weighted_cuda.launches += 1
        return out

    return _zenith_groups(launch, u0s, max_group // nG, zw=zw)


two_stream_solar_multi_weighted_cuda.launches = 0


def _launch_ir_rows(tau, w0, gt, emissivity, bplanck, hard, tau_min):
    """The unreduced IR solve, the weighted IR kernel with one gauss point of
    weight 1: (fup, fdn), each (rows, nz+1)."""
    _, fup, fdn = _launch(False, False, tau, w0, gt, emissivity, bplanck, None, None, None, hard,
                          tau_min)
    return fup, fdn


def _launch_solar_multi(tau, w0, gt, u0s, Rsfc, per_row=False):
    """The unreduced solar kernels, one launch: the multi-zenith one for any
    number of zenith cosines u0s (nzen,), or the single-zenith one for one
    cosine per row (``per_row``, u0s (rows,)). Returns (amean, srad, fup,
    fdn) with a leading zenith axis (of length 1 per row)."""
    rows, nz = tau.shape
    nzen = 1 if per_row else u0s.shape[0]
    if w0.shape != tau.shape or gt.shape != tau.shape or Rsfc.shape != (rows,):
        raise ValueError("tau/w0/gt must be (rows, nz) and Rsfc (rows,)")
    if per_row and u0s.shape != (rows,):
        raise ValueError(f"u0 must be (rows,), not {tuple(u0s.shape)}")
    if u0s.ndim != 1 or nzen < 1:
        raise ValueError(f"u0s must be (nzen,) with nzen >= 1, not {tuple(u0s.shape)}")
    kw = dict(dtype=tau.dtype, device=tau.device)
    # q (nz, 2, rows), tauc (nz, rows) and p (nz, 2, rows * nzen)
    scratch = torch.empty(nz * rows * (3 + 2 * nzen), **kw)
    am, fup, fdn = (torch.empty((nzen, rows, nz + 1), **kw) for _ in range(3))
    srad = torch.empty((nzen, rows), **kw)
    fn = load_library("twostream")["clima_twostream_solar_multi"]
    status = fn(int(tau.dtype == torch.float64), int(per_row), tau.data_ptr(), w0.data_ptr(),
                gt.data_ptr(), Rsfc.data_ptr(), u0s.data_ptr(), nzen, rows, nz,
                scratch.data_ptr(), am.data_ptr(), fup.data_ptr(), fdn.data_ptr(),
                srad.data_ptr(), torch.cuda.current_stream(tau.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"two-stream kernel launch failed: CUDA error {status}")
    return am, srad, fup, fdn


def _zenith_groups(solve, u0s, size, zw=None):
    """``solve`` over consecutive groups of at most ``size`` zenith angles.
    Each zenith's solve is independent of the others', so this is exact:
    per-zenith outputs (``zw`` None, ``solve(u0s_group)``) are joined along
    their leading zenith axis; zenith-weighted ones (``solve(u0s_group,
    zw_group)``) are summed, being linear in zw."""
    groups = [slice(i, i + size) for i in range(0, u0s.shape[0], size)]
    if zw is None:
        outs = [solve(u0s[g]) for g in groups]
        return outs[0] if len(outs) == 1 else tuple(torch.cat(parts) for parts in zip(*outs))
    total = solve(u0s[groups[0]], zw[groups[0]])
    for g in groups[1:]:
        total = tuple(None if a is None else a + b
                      for a, b in zip(total, solve(u0s[g], zw[g])))
    return total


def _device_checked(tensors):
    tau = tensors["tau"]
    if tau.device.type != "cuda":
        raise ValueError(f"no two-stream kernel for device {tau.device}")
    if tau.ndim != 2:
        raise ValueError(f"the kernels take a 2-D (rows, nz) batch, not {tuple(tau.shape)}")
    _check(tensors, tau.dtype, tau.device)


def two_stream_ir_auto(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck):
    """IR two-stream per row (JAX ``ops.twostream.two_stream_ir_auto``).

    tau/w0/gt (rows, nz) TOA-down, emissivity (rows,), bplanck (rows, nz+1);
    ``tau_min`` a float. Returns (fup, fdn), each (rows, nz+1). On the card
    the weighted IR kernel with one gauss point of weight 1, which leaves
    each value as it is but for the sign of a zero. Twin:
    :func:`.twostream.two_stream_ir`; plain model of the kernel's schedule:
    :func:`ir_rows_schedule_ref`.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_ir(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck)
    if not isinstance(tau_min, (int, float)):
        raise TypeError("tau_min must be a Python float for the kernel")
    _device_checked(dict(tau=tau, w0=w0, gt=gt, emissivity=emissivity, bplanck=bplanck))
    out = _launch_ir_rows(tau, w0, gt, emissivity, bplanck, has_hard_surface, tau_min)
    two_stream_ir_auto.launches += 1
    return out


two_stream_ir_auto.launches = 0


def two_stream_solar_multi_auto(tau, w0, gt, u0s, Rsfc):
    """Multi-zenith solar two-stream per row (JAX
    ``ops.twostream.two_stream_solar_multi_auto``).

    tau/w0/gt (rows, nz) TOA-down, u0s (nzen,) shared by all rows, Rsfc
    (rows,). Returns (amean, surface_radiance, fup, fdn): amean/fup/fdn
    (nzen, rows, nz+1), surface_radiance (nzen, rows). On the card one
    launch takes any number of zenith angles. Twin:
    :func:`.twostream.two_stream_solar_multi`; plain model of the kernel's
    schedule: :func:`solar_rows_schedule_ref`.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_solar_multi(tau, w0, gt, u0s, Rsfc)
    _device_checked(dict(tau=tau, w0=w0, gt=gt, u0s=u0s, Rsfc=Rsfc))
    out = _launch_solar_multi(tau, w0, gt, u0s, Rsfc)
    two_stream_solar_multi_auto.launches += 1
    return out


two_stream_solar_multi_auto.launches = 0


def two_stream_solar_auto(tau, w0, gt, u0, Rsfc):
    """Single-zenith solar two-stream with one zenith cosine per row (JAX
    ``ops.twostream.two_stream_solar_auto``).

    tau/w0/gt (rows, nz) TOA-down, u0 (rows,), Rsfc (rows,). Returns
    (amean, surface_radiance, fup, fdn): amean/fup/fdn (rows, nz+1),
    surface_radiance (rows,). On the card the single-zenith solar kernel.
    Twin: :func:`.twostream.two_stream_solar`; plain model of the kernel's
    schedule: :func:`solar_rows_schedule_ref` with ``per_row``.
    """
    if tau.device.type == "cpu":
        return ts.two_stream_solar(tau, w0, gt, u0, Rsfc)
    _device_checked(dict(tau=tau, w0=w0, gt=gt, u0=u0, Rsfc=Rsfc))
    out = tuple(x[0] for x in _launch_solar_multi(tau, w0, gt, u0, Rsfc, per_row=True))
    two_stream_solar_auto.launches += 1
    return out


two_stream_solar_auto.launches = 0


def _solar_layer_ref(tau, w0, gt, tauc, u0):
    """One layer's coefficients as the kernels' ``solar_layer`` forms them:
    tau/w0/gt/tauc (rows, 1), u0 (1, nzen) or, one cosine per row, (rows, 1).
    e1-e4, the scaled tau and tauc are (rows, 1), the sources (rows, nzen)."""
    s3 = ts._SQRT3
    gg = gt * gt
    tau_s = tau * (1.0 - w0 * gg)
    w0_s = w0 * (1.0 - gg) / (1.0 - w0 * gg)
    gt_s = gt / (1.0 + gt)
    gam1 = s3 * (2.0 - w0_s * (1.0 + gt_s)) / 2.0
    gam2 = s3 * w0_s * (1.0 - gt_s) / 2.0
    lam = torch.sqrt(gam1 * gam1 - gam2 * gam2)
    e1, e2, e3, e4 = ts._es(lam, gam2 / (gam1 + lam), tau_s)
    inv_u0 = 1.0 / u0
    gam3 = (1.0 - s3 * gt_s * u0) / 2.0
    gam4 = 1.0 - gam3
    facp = w0_s * ((gam1 - inv_u0) * gam3 + gam4 * gam2)
    facm = w0_s * ((gam1 + inv_u0) * gam4 + gam2 * gam3)
    et0 = torch.exp(-tauc / u0)
    etb = et0 * torch.exp(-tau_s / u0)
    denom = lam * lam - inv_u0 * inv_u0
    return dict(e1=e1, e2=e2, e3=e3, e4=e4, tau=tau_s, tauc=tauc, cp0=et0 * facp / denom,
                cpb=etb * facp / denom, cm0=et0 * facm / denom, cmb=etb * facm / denom,
                dir_b=u0 * etb)


def _eliminate_ref(nz, layer, surface, zero):
    """The forward elimination the kernels share, top to bottom: ``layer(k)``
    gives layer k's coefficients, ``surface(c)`` the bottom block's (Aod,
    Bod, Eod) from the bottom layer's. Returns q and p per layer, each a pair
    of (rows, ...) tensors."""
    q, p = [None] * nz, [None] * nz
    cur = layer(0)
    Aev, Bev, Dev, Eev, p1prev, q1prev = zero, cur["e1"], -cur["e2"], -cur["cm0"], zero, zero
    for k in range(nz):
        c = cur
        if k < nz - 1:
            n = layer(k + 1)
            Aod = n["e2"] * c["e1"] - c["e3"] * n["e4"]
            Bod = c["e2"] * n["e2"] - c["e4"] * n["e4"]
            Dod = n["e1"] * n["e4"] - n["e2"] * n["e3"]
            Eod = n["e2"] * (n["cp0"] - c["cpb"]) - n["e4"] * (n["cm0"] - c["cmb"])
            nxt_ev = (c["e2"] * c["e3"] - c["e4"] * c["e1"], c["e1"] * n["e1"] - c["e3"] * n["e3"],
                      c["e3"] * n["e4"] - c["e1"] * n["e2"],
                      c["e3"] * (n["cp0"] - c["cpb"]) + c["e1"] * (c["cmb"] - n["cm0"]))
        else:
            (Aod, Bod, Eod), Dod = surface(c), zero
        M00 = Bev - Aev * q1prev
        inv_det = 1.0 / (M00 * Bod - Dev * Aod)
        X00, X01, X10, X11 = Bod * inv_det, -Dev * inv_det, -Aod * inv_det, M00 * inv_det
        q1prev = X11 * Dod
        q[k] = (X01 * Dod, q1prev)
        f0 = Eev - Aev * p1prev
        p1prev = X10 * f0 + X11 * Eod
        p[k] = (X00 * f0 + X01 * Eod, p1prev)
        if k < nz - 1:
            cur = n
            Aev, Bev, Dev, Eev = nxt_ev
    return q, p


def _back_substitute_ref(q, p, layer):
    """The backward pass the kernels share: for each layer k, bottom to top,
    yields (k, y1, y2, c), u_k = (y1, y2) = p_k - q_k u_{k+1}[0] and c =
    ``layer(k)`` the layer's coefficients recomputed."""
    unext = 0.0
    for k in range(len(q) - 1, -1, -1):
        y1 = p[k][0] - q[k][0] * unext
        y2 = p[k][1] - q[k][1] * unext
        unext = y1
        yield k, y1, y2, layer(k)


def _solar_solve_ref(tau, w0, gt, u0, Rsfc):
    """The solar kernels' schedule, a thread per (row, zenith) as the tensor
    axes (rows, nzen): u0 (1, nzen) shared, or (rows, 1) one cosine per row.
    Forward: layer coefficients top to bottom, the running tauc and the
    2x2-block Thomas elimination, q and tauc (rows, 1) and p (rows, nzen)
    stored per layer. Backward: yields (k, y1, y2, c) per layer, bottom to
    top, c recomputed from the stored tauc."""
    rows, nz = tau.shape
    col = lambda x, k: x[:, k:k + 1]
    zero = torch.zeros((rows, 1), dtype=tau.dtype, device=tau.device)
    Rs = Rsfc[:, None]
    tau_s = tau * (1.0 - w0 * (gt * gt))  # each layer's delta-scaled tau, as solar_layer's
    tauc_k = [zero]  # the running sum from the top, in the kernels' order
    for k in range(nz - 1):
        tauc_k.append(tauc_k[k] + col(tau_s, k))
    layer = lambda k: _solar_layer_ref(col(tau, k), col(w0, k), col(gt, k), tauc_k[k], u0)
    surface = lambda c: (c["e1"] - Rs * c["e3"], c["e2"] - Rs * c["e4"],
                         Rs * c["dir_b"] - c["cpb"] + Rs * c["cmb"])
    q, p = _eliminate_ref(nz, layer, surface, zero)
    return _back_substitute_ref(q, p, layer)


def solar_weighted_schedule_ref(tau, w0, gt, u0s, Rsfc, zw, wbin, with_amean=True):
    """Plain PyTorch model of the weighted solar kernel's schedule, for the
    tests; no path calls it. Same arguments and outputs as
    :func:`two_stream_solar_multi_weighted_cuda`.

    (rows, nzen) are tensor axes where the kernel has a thread per pair. The
    forward pass loops over layers top to bottom: layer coefficients, the
    2x2-block Thomas elimination, and q, tauc (per row) and p (per row and
    zenith) stored per layer. The backward pass, bottom to top, forms u_k =
    p_k - q_k u_{k+1}[0], recomputes the layer's coefficients from the stored
    tauc and reduces its edge fluxes at once: zeniths in order with zw, then
    the gauss rows of each group in order with wbin, the kernel's order.
    """
    rows, nz = tau.shape
    nzen, nG = u0s.shape[0], wbin.shape[0]
    u0 = u0s[None, :]

    def reduce(v):  # (rows, nzen) -> (groups,): zeniths in order, then gauss rows
        acc = torch.zeros(rows, dtype=tau.dtype, device=tau.device)
        for z in range(nzen):
            acc = acc + zw[z] * v[:, z]
        acc = acc.reshape(-1, nG)
        s = torch.zeros(acc.shape[0], dtype=tau.dtype, device=tau.device)
        for g in range(nG):
            s = s + wbin[g] * acc[:, g]
        return s

    n_out = 3 if with_amean else 2
    out = [[None] * (nz + 1) for _ in range(n_out)]
    u1 = 1.0 / ts._SQRT3
    for k, y1, y2, c in _solar_solve_ref(tau, w0, gt, u0, Rsfc):
        fup_t = y1 * c["e3"] - y2 * c["e4"] + c["cp0"]
        bot = [y1 * c["e1"] + y2 * c["e2"] + c["cpb"],
               y1 * c["e3"] + y2 * c["e4"] + c["cmb"] + c["dir_b"]]
        top = [fup_t, u0.expand(rows, nzen)]
        if with_amean:
            bot.append((1.0 / u1) * (y1 * (c["e1"] + c["e3"]) + y2 * (c["e2"] + c["e4"])
                                     + c["cpb"] + c["cmb"]) + c["dir_b"] / u0)
            top.append((1.0 / u1) * fup_t + u0 / u0)
        for o in range(n_out):
            out[o][k + 1] = reduce(bot[o])
            if k == 0:
                out[o][0] = reduce(top[o])
    fup, fdn, *am = (torch.stack(edges, dim=-1) for edges in out)
    return (am[0] if with_amean else None), fup, fdn


def solar_rows_schedule_ref(tau, w0, gt, u0s, Rsfc, per_row=False):
    """Plain PyTorch model of the unreduced solar kernels' schedule, for the
    tests; no path calls it. Same arguments and outputs as
    :func:`two_stream_solar_multi_auto`, or with ``per_row`` (u0s (rows,),
    one zenith cosine per row: the single-zenith kernel, whose input tiles
    change no value) as :func:`two_stream_solar_auto`.

    (rows, nzen) are tensor axes where the kernel has a thread per pair. The
    forward pass is the weighted solar kernel's. The backward pass, bottom to
    top, forms u_k = p_k - q_k u_{k+1}[0], recomputes the layer's
    coefficients from the stored tauc and forms the layer's lower edge (at
    the top layer also the upper edge) of amean, fup and fdn at once, and at
    the bottom layer the surface radiance from tauc plus the layer's optical
    depth.
    """
    nz = tau.shape[1]
    u0 = u0s[:, None] if per_row else u0s[None, :]
    u1 = 1.0 / ts._SQRT3
    out = [[None] * (nz + 1) for _ in range(3)]  # amean, fup, fdn: (rows, nzen) per edge
    for k, y1, y2, c in _solar_solve_ref(tau, w0, gt, u0, Rsfc):
        fdn_b = y1 * c["e3"] + y2 * c["e4"] + c["cmb"]
        out[0][k + 1] = ((1.0 / u1) * (y1 * (c["e1"] + c["e3"]) + y2 * (c["e2"] + c["e4"])
                                       + c["cpb"] + c["cmb"]) + c["dir_b"] / u0)
        out[1][k + 1] = y1 * c["e1"] + y2 * c["e2"] + c["cpb"]
        out[2][k + 1] = fdn_b + c["dir_b"]
        if k == nz - 1:
            srad = fdn_b / u1 + torch.exp(-(c["tauc"] + c["tau"]) / u0)
        if k == 0:
            fup_t = y1 * c["e3"] - y2 * c["e4"] + c["cp0"]
            out[0][0] = (1.0 / u1) * fup_t + u0 / u0
            out[1][0] = fup_t
            out[2][0] = u0.expand_as(fup_t)
    am, fup, fdn = (torch.stack(edges, dim=-1).transpose(0, 1) for edges in out)
    if per_row:
        return am[0], srad[:, 0], fup[0], fdn[0]
    return am, srad.T, fup, fdn


def _ir_layer_ref(tau, w0, gt, b_top, b_bot, tau_min):
    """One layer's coefficients as the kernel's ``ir_layer`` forms them, each
    (rows, 1): e1-e4 and the Planck sources cp0, cpb, cm0, cmb."""
    gam1 = 2.0 - w0 * (1.0 + gt)
    gam2 = w0 * (1.0 - gt)
    lam = torch.sqrt(gam1 * gam1 - gam2 * gam2)
    e1, e2, e3, e4 = ts._es(lam, gam2 / (gam1 + lam), tau)
    thin = tau <= tau_min
    b0n = torch.where(thin, 0.5 * (b_top + b_bot), b_top)
    b1n = torch.where(thin, torch.zeros_like(tau),
                      (b_bot - b_top) / torch.where(thin, torch.ones_like(tau), tau))
    inv_g = 1.0 / (gam1 + gam2)
    norm = const.pi  # 2 pi u1, u1 = 0.5
    return dict(e1=e1, e2=e2, e3=e3, e4=e4, cp0=norm * (b0n + b1n * inv_g),
                cpb=norm * (b0n + b1n * (tau + inv_g)), cm0=norm * (b0n - b1n * inv_g),
                cmb=norm * (b0n + b1n * (tau - inv_g)))


def _ir_edges_ref(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck):
    """The IR kernel's schedule, a thread per row as the tensor axis: the
    forward pass (layer coefficients and the 2x2-block Thomas elimination top
    to bottom, q and p stored per layer), then for each layer, bottom to top,
    u_k = p_k - q_k u_{k+1}[0] and the layer's coefficients recomputed.
    Yields (k, fup_b, fdn_b, fup_t): the layer's lower edge fluxes and its
    upper edge's fup (fdn there is 0), each (rows, 1)."""
    rows, nz = tau.shape
    col = lambda x, k: x[:, k:k + 1]
    layer = lambda k: _ir_layer_ref(col(tau, k), col(w0, k), col(gt, k), col(bplanck, k),
                                    col(bplanck, k + 1), tau_min)
    zero = torch.zeros((rows, 1), dtype=tau.dtype, device=tau.device)
    em, b_sfc = emissivity[:, None], col(bplanck, nz)
    if has_hard_surface:
        Rs, Ss = 1.0 - em, em * const.pi * b_sfc
    else:
        tb = col(tau, nz - 1)
        thin = tb <= tau_min
        b1_bot = torch.where(thin, zero, (b_sfc - col(bplanck, nz - 1))
                             / torch.where(thin, torch.ones_like(tb), tb))
        Rs, Ss = zero, const.pi * (b_sfc + 0.5 * b1_bot)
    surface = lambda c: (c["e1"] - Rs * c["e3"], c["e2"] - Rs * c["e4"],
                         Ss - c["cpb"] + Rs * c["cmb"])
    q, p = _eliminate_ref(nz, layer, surface, zero)
    for k, y1, y2, c in _back_substitute_ref(q, p, layer):
        yield (k, y1 * c["e1"] + y2 * c["e2"] + c["cpb"], y1 * c["e3"] + y2 * c["e4"] + c["cmb"],
               y1 * c["e3"] - y2 * c["e4"] + c["cp0"])


def ir_weighted_schedule_ref(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck,
                             wbin):
    """Plain PyTorch model of the weighted IR kernel's schedule, for the
    tests; no path calls it. Same arguments and outputs as
    :func:`two_stream_ir_weighted_cuda`.

    Rows are a tensor axis where the kernel has a thread per row. The forward
    pass loops over layers top to bottom: layer coefficients, the 2x2-block
    Thomas elimination, and q and p stored per layer. The backward pass,
    bottom to top, forms u_k = p_k - q_k u_{k+1}[0], recomputes the layer's
    coefficients and stages its edge fluxes; every 8 edges (the kernel's
    kIrEdges) and after the top layer each staged edge is reduced over the
    gauss rows of each group in order with wbin, the kernel's order.
    """
    nz, nG = tau.shape[1], wbin.shape[0]

    def reduce(v):  # (rows, 1) -> (groups,): the gauss rows of each group in order
        v = v.reshape(-1, nG)
        s = torch.zeros(v.shape[0], dtype=tau.dtype, device=tau.device)
        for g in range(nG):
            s = s + wbin[g] * v[:, g]
        return s

    fup, fdn = [None] * (nz + 1), [None] * (nz + 1)
    staged = []  # (edge, fup, fdn) of the edges not yet reduced
    for k, fup_b, fdn_b, fup_t in _ir_edges_ref(tau, w0, gt, emissivity, has_hard_surface,
                                                tau_min, bplanck):
        staged.append((k + 1, fup_b, fdn_b))
        if k == 0:
            staged.append((0, fup_t, torch.zeros_like(fup_t)))
        if len(staged) >= 8 or k == 0:
            for j, up, dn in staged:
                fup[j], fdn[j] = reduce(up), reduce(dn)
            staged = []
    return torch.stack(fup, dim=-1), torch.stack(fdn, dim=-1)


def ir_rows_schedule_ref(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck):
    """Plain PyTorch model of the unreduced IR solve's schedule, for the
    tests; no path calls it. Same arguments and outputs as
    :func:`two_stream_ir_auto`: the weighted IR kernel's schedule
    (:func:`ir_weighted_schedule_ref`) with one gauss point of weight 1.
    """
    one = torch.ones(1, dtype=tau.dtype, device=tau.device)
    return ir_weighted_schedule_ref(tau, w0, gt, emissivity, has_hard_surface, tau_min, bplanck,
                                    one)
