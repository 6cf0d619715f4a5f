"""Tridiagonal solves on tensors: 2x2-block PCR (the two-stream twins' solver),
scalar PCR and Thomas (the test oracle, and the twins' solve under
``ops.twostream.set_tridiag_method("thomas")``).

The reference solves one 2*nz tridiagonal system per (wavelength bin, gauss
point, zenith angle) serially (``src/radtran/clima_radtran_twostream.f90:
297-316``). Here the block structure of the two-stream system is solved by
2x2-block parallel cyclic reduction: ceil(log2 nz) whole-tensor sweeps, with
the whole (columns x bins x gauss x zenith) batch in the leading dims. Scalar
pivots vanish in optically thin layers; the 2x2 blocks stay well conditioned.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "tridiag",
    "tridiag_batched_last",
    "tridiag_pcr",
    "tridiag_block2_pcr",
    "block2_pcr_components",
    "block2_pcr_components_multi",
    "block2_pcr_components_dense",
]


def tridiag(a, b, c, d):
    """Solve tridiagonal systems along axis 0 with batch dims trailing (Thomas).

    ``a``: sub-diagonal (n, ...), a[0] unused. ``b``: diagonal (n, ...).
    ``c``: super-diagonal (n, ...), c[n-1] unused. ``d``: right-hand side.

    Matches the in-place elimination of the reference ``tridiag``
    (clima_radtran_twostream.f90:297-316). A sequential loop over n: the
    oracle for the block solvers, not a production path.
    """
    n = a.shape[0]
    cp = [c[0] / b[0]]
    dp = [d[0] / b[0]]
    for i in range(1, n):
        denom = b[i] - a[i] * cp[-1]
        cp.append(c[i] / denom)
        dp.append((d[i] - a[i] * dp[-1]) / denom)
    x = [dp[n - 1]]
    for i in range(n - 2, -1, -1):
        x.append(dp[i] - cp[i] * x[-1])
    return torch.stack(x[::-1], dim=0)


def tridiag_batched_last(a, b, c, d):
    """Thomas solve along the LAST axis (batch dims leading); the bands and
    the right-hand side broadcast to a common shape."""
    a, b, c, d = torch.broadcast_tensors(*(torch.as_tensor(x) for x in (a, b, c, d)))
    mv = lambda x: x.movedim(-1, 0)
    return tridiag(mv(a), mv(b), mv(c), mv(d)).movedim(0, -1)


def tridiag_pcr(a, b, c, d):
    """Scalar parallel cyclic reduction along the LAST axis (batch dims
    leading): ceil(log2 n) whole-tensor elimination sweeps. Stable for
    diagonally dominant systems; the two-stream system is not one in
    optically thin layers, where :func:`tridiag_block2_pcr` serves.
    a[..., 0] and c[..., -1] are ignored, as in the Thomas convention."""
    a, b, c, d = torch.broadcast_tensors(*(torch.as_tensor(x) for x in (a, b, c, d)))
    n = a.shape[-1]
    # the unused first sub- and last super-diagonal entries must be exactly 0
    a = torch.cat([torch.zeros_like(a[..., :1]), a[..., 1:]], dim=-1)
    c = torch.cat([c[..., :-1], torch.zeros_like(c[..., -1:])], dim=-1)
    for s in range(max(1, math.ceil(math.log2(n)))):
        k = 1 << s
        # neighbours from the system before this sweep
        alpha = a / _shift(b, -k, 1.0)
        gamma = c / _shift(b, +k, 1.0)
        a, b, c, d = (-alpha * _shift(a, -k, 0.0),
                      b - alpha * _shift(c, -k, 0.0) - gamma * _shift(a, +k, 0.0),
                      -gamma * _shift(c, +k, 0.0),
                      d - alpha * _shift(d, -k, 0.0) - gamma * _shift(d, +k, 0.0))
    return d / b


def tridiag_block2_pcr(a, b, c, d):
    """Block PCR for even-size tridiagonal systems, along the LAST axis.

    The calling convention of :func:`tridiag_batched_last`; n must be even.
    Rows 2k and 2k+1 form the 2x2 block k, solved by
    :func:`block2_pcr_components`: the two-stream system's block structure,
    whose blocks stay well conditioned where scalar pivots vanish.
    """
    a, b, c, d = torch.broadcast_tensors(*(torch.as_tensor(x) for x in (a, b, c, d)))
    n = a.shape[-1]
    if n % 2:
        raise ValueError(f"tridiag_block2_pcr needs an even system size, not {n}")
    a = torch.cat([torch.zeros_like(a[..., :1]), a[..., 1:]], dim=-1)
    c = torch.cat([c[..., :-1], torch.zeros_like(c[..., -1:])], dim=-1)
    u0, u1 = block2_pcr_components(a[..., 0::2], b[..., 0::2], c[..., 0::2], a[..., 1::2],
                                   b[..., 1::2], c[..., 1::2], d[..., 0::2], d[..., 1::2])
    return torch.stack([u0, u1], dim=-1).reshape(a.shape)


def _shift(x, k, fill):
    """x[..., i+k] along the last axis, out-of-range entries set to ``fill``."""
    pad = torch.full(x.shape[:-1] + (abs(k),), fill, dtype=x.dtype, device=x.device)
    if k > 0:
        return torch.cat([x[..., k:], pad], dim=-1)
    return torch.cat([pad, x[..., :k]], dim=-1)


def block2_pcr_components(L01, M00, M01, M10, M11, U10, f0, f1):
    """2x2-block PCR on pre-split block components.

    Block row k (rows 2k, 2k+1; unknowns u_k = (x_{2k}, x_{2k+1})):
      L_k u_{k-1} + M_k u_k + U_k u_{k+1} = f_k
    with L_k = [[0, L01_k], [0, 0]], U_k = [[0, 0], [U10_k, 0]],
    M_k = [[M00, M01], [M10, M11]]_k. All inputs broadcast to (..., m).

    One sweep preserves the sparsity of L and U exactly (alpha = L inv(M_m)
    has one row, gamma = U inv(M_p) one row), so only M00, M11, L01, U10 and
    the right-hand side change; M01/M10 are loop invariants.
    Returns (u0, u1), each (..., m).
    """
    u0s, u1s = block2_pcr_components_multi(L01, M00, M01, M10, M11, U10,
                                           f0[None], f1[None])
    return u0s[0], u1s[0]


def block2_pcr_components_multi(L01, M00, M01, M10, M11, U10, f0s, f1s):
    """2x2-block PCR with a SHARED matrix and multiple right-hand sides.

    ``f0s``/``f1s`` carry a leading RHS axis: ``(nrhs,) + batch + (m,)``
    against matrix components broadcastable to ``batch + (m,)``. Each sweep
    computes the elimination factors once and applies them to every RHS —
    what makes the multi-zenith solar two-stream cheap (u0 enters only the
    RHS). Returns ``(u0s, u1s)``, each ``(nrhs,) + batch + (m,)``.
    """
    batch = torch.broadcast_shapes(*(x.shape for x in (L01, M00, M01, M10, M11, U10)),
                                   f0s.shape[1:], f1s.shape[1:])
    L01, M00, M01, M10, M11, U10 = (x.expand(batch) for x in (L01, M00, M01, M10, M11, U10))
    f0s = f0s.expand((f0s.shape[0],) + batch)
    f1s = f1s.expand((f1s.shape[0],) + batch)
    m = batch[-1]

    for s in range(max(1, math.ceil(math.log2(m)))):
        k = 1 << s
        inv_det = 1.0 / (M00 * M11 - M01 * M10)
        i00 = M11 * inv_det
        i01 = -M01 * inv_det
        i10 = -M10 * inv_det
        i11 = M00 * inv_det

        # alpha couples to block k-1 (needs inv(M_{k-1}) row 2), gamma to
        # block k+1 (needs inv(M_{k+1}) row 1); identity fill off the ends
        a0 = L01 * _shift(i10, -k, 0.0)
        a1 = L01 * _shift(i11, -k, 1.0)
        g0 = U10 * _shift(i00, +k, 1.0)
        g1 = U10 * _shift(i01, +k, 0.0)

        L01_new = -a0 * _shift(L01, -k, 0.0)
        U10_new = -g1 * _shift(U10, +k, 0.0)
        M00 = M00 - a1 * _shift(U10, -k, 0.0)
        M11 = M11 - g0 * _shift(L01, +k, 0.0)
        f0_new = f0s - a0 * _shift(f0s, -k, 0.0) - a1 * _shift(f1s, -k, 0.0)
        f1_new = f1s - g0 * _shift(f0s, +k, 0.0) - g1 * _shift(f1s, +k, 0.0)
        L01, U10, f0s, f1s = L01_new, U10_new, f0_new, f1_new

    inv_det = 1.0 / (M00 * M11 - M01 * M10)
    u0s = (M11 * f0s - M01 * f1s) * inv_det
    u1s = (M00 * f1s - M10 * f0s) * inv_det
    return u0s, u1s


def block2_pcr_components_dense(L01, M00, M01, M10, M11, U10, f0, f1):
    """Dense 2x2-block PCR: the same block system as
    :func:`block2_pcr_components`, each sweep in full 2x2 matrix algebra on
    (L, M, U) without using their sparsity (the oracle of the structured
    form). Returns (u0, u1), each (..., m)."""
    batch = torch.broadcast_shapes(*(x.shape for x in (L01, M00, M01, M10, M11, U10, f0, f1)))
    bc = lambda x: x.expand(batch)
    zeros = torch.zeros(batch, dtype=M00.dtype, device=M00.device)
    L = (zeros, bc(L01), zeros, zeros)  # (l00, l01, l10, l11)
    U = (zeros, zeros, bc(U10), zeros)
    M = (bc(M00), bc(M01), bc(M10), bc(M11))
    f = (bc(f0), bc(f1))
    zero_fill, identity_fill = (0.0, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 1.0)

    def shift_t(t, k, fills):
        return tuple(_shift(x, k, fill) for x, fill in zip(t, fills))

    def inv2(A):
        a00, a01, a10, a11 = A
        inv_det = 1.0 / (a00 * a11 - a01 * a10)
        return (a11 * inv_det, -a01 * inv_det, -a10 * inv_det, a00 * inv_det)

    def mm(A, B):
        a00, a01, a10, a11 = A
        b00, b01, b10, b11 = B
        return (a00 * b00 + a01 * b10, a00 * b01 + a01 * b11,
                a10 * b00 + a11 * b10, a10 * b01 + a11 * b11)

    def mv(A, v):
        return (A[0] * v[0] + A[1] * v[1], A[2] * v[0] + A[3] * v[1])

    for s in range(max(1, math.ceil(math.log2(batch[-1])))):
        k = 1 << s
        L_m, U_m, M_m = shift_t(L, -k, zero_fill), shift_t(U, -k, zero_fill), \
            shift_t(M, -k, identity_fill)
        L_p, U_p, M_p = shift_t(L, +k, zero_fill), shift_t(U, +k, zero_fill), \
            shift_t(M, +k, identity_fill)
        f_m, f_p = shift_t(f, -k, (0.0, 0.0)), shift_t(f, +k, (0.0, 0.0))
        alpha = mm(L, inv2(M_m))
        gamma = mm(U, inv2(M_p))
        af, gf = mv(alpha, f_m), mv(gamma, f_p)
        L, U, M, f = (tuple(-x for x in mm(alpha, L_m)), tuple(-x for x in mm(gamma, U_p)),
                      tuple(x - y - z for x, y, z in zip(M, mm(alpha, U_m), mm(gamma, L_p))),
                      (f[0] - af[0] - gf[0], f[1] - af[1] - gf[1]))
    return mv(inv2(M), f)
