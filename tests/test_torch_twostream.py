"""Two-stream twins of the PyTorch port against clima_tpu (float64, CPU):
the XLA-path twins at rtol 1e-12 (same math), the Pallas kernels in
interpret mode at rtol 1e-9 / atol 1e-12 (the JAX tests' own bound), the
plain models of the weighted IR and solar kernels' schedules at that bound
and of the unreduced kernels' (IR, solar with shared zenith cosines and with
one per row) at rtol 1e-10, the zenith grouping of the kernel wrappers, and
their CPU dispatch."""

import functools
from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl

from clima_tpu.ops import twostream as ref_ts
from clima_tpu.ops import pallas_twostream as pts
from clima_tpu.ops import tridiag as ref_tridiag

from clima_tpu_torch.ops import tridiag, twostream as ts, twostream_cuda as tc
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


# XLA twins share the math; values below ATOL_TWIN are rounding noise of
# O(1) fluxes (cancellation deep in the column)
RTOL_TWIN, ATOL_TWIN = 1e-12, 1e-15
RTOL_KERNEL, ATOL_KERNEL = 1e-9, 1e-12


@pytest.fixture()
def interpret():
    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)):
        yield


def _atm(B, nz, seed):
    rng = np.random.default_rng(seed)
    tau = rng.uniform(1e-6, 2.0, (B, nz))
    w0 = rng.uniform(0.02, 0.999, (B, nz))
    gt = rng.uniform(0.0, 0.85, (B, nz))
    return tau, w0, gt


def _close(got, want, rtol, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


J = lambda *xs: [jnp.asarray(x) for x in xs]
T = lambda *xs: [torch.tensor(x) for x in xs]


@pytest.mark.parametrize("hard", [True, False])
def test_ir_weighted_matches_reference(interpret, hard):
    nw, nG, nz = 5, 8, 21
    B = nw * nG
    tau, w0, gt = _atm(B, nz, seed=7)
    rng = np.random.default_rng(8)
    emis = rng.uniform(0.8, 1.0, B)
    bpl = rng.uniform(1e-2, 1.0, (B, nz + 1))
    wbin = np.polynomial.legendre.leggauss(nG)[1] / 2.0
    tau[2, 5] = 1e-7  # the thin-layer branch

    ref_args = lambda a: (*a[:4], hard, 1e-6, *a[4:])
    xla = ref_ts.two_stream_ir_weighted(*ref_args(J(tau, w0, gt, emis, bpl, wbin)))
    kern = pts.two_stream_ir_weighted_pallas(*ref_args(J(tau, w0, gt, emis, bpl, wbin)),
                                             block_b=16)
    got = ts.two_stream_ir_weighted(*ref_args(T(tau, w0, gt, emis, bpl, wbin)))
    assert got[0].shape == (nw, nz + 1)
    _close(got, xla, RTOL_TWIN, ATOL_TWIN)
    _close(got, kern, RTOL_KERNEL, ATOL_KERNEL)
    # the kernel wrapper runs the twin for CPU tensors
    _close(tc.two_stream_ir_weighted_cuda(*ref_args(T(tau, w0, gt, emis, bpl, wbin))),
           [g.numpy() for g in got], 0.0, 0.0)


@pytest.mark.parametrize("with_amean", [True, False])
def test_solar_multi_weighted_matches_reference(interpret, with_amean):
    nw, nG, nz, nzen = 7, 4, 33, 3
    B = nw * nG
    tau, w0, gt = _atm(B, nz, seed=5)
    tau[2, 5] = 1e-7
    rng = np.random.default_rng(6)
    u0s = rng.uniform(0.2, 1.0, nzen)
    rs = rng.uniform(0.0, 0.6, B)
    zw = rng.uniform(0.1, 0.5, nzen)
    wbin = np.polynomial.legendre.leggauss(nG)[1] / 2.0

    xla = ref_ts.two_stream_solar_multi_weighted(*J(tau, w0, gt, u0s, rs, zw, wbin),
                                                 with_amean=with_amean)
    kern = pts.two_stream_solar_multi_weighted_pallas(*J(tau, w0, gt, u0s, rs, zw, wbin),
                                                      block_b=8, with_amean=with_amean)
    got = ts.two_stream_solar_multi_weighted(*T(tau, w0, gt, u0s, rs, zw, wbin),
                                             with_amean=with_amean)
    assert got[1].shape == (nw, nz + 1)
    _close(got, xla, RTOL_TWIN, ATOL_TWIN)
    _close(got, kern, RTOL_KERNEL, ATOL_KERNEL)
    wrapped = tc.two_stream_solar_multi_weighted_cuda(*T(tau, w0, gt, u0s, rs, zw, wbin),
                                                      with_amean=with_amean)
    _close(wrapped, [None if g is None else g.numpy() for g in got], 0.0, 0.0)


_ir_weighted_xla = jax.jit(ref_ts.two_stream_ir_weighted, static_argnums=(4, 5))


@pytest.mark.parametrize("nG, nz, hard", [(1, 21, True), (1, 37, False), (4, 21, False),
                                           (4, 37, True), (8, 21, True), (8, 37, False),
                                           (16, 21, False), (16, 37, True)])
def test_ir_weighted_schedule_ref_matches_reference(interpret, nG, nz, hard):
    """The plain model of the weighted IR kernel's schedule (a thread per row,
    back substitution fused with the edge fluxes, 8 edges staged per
    reduction, the gauss rows summed in order) against the JAX package's
    Pallas kernel in interpret mode and its XLA path, with a thin layer, at
    layer counts that are no multiple of 16: every gauss group size with a
    hard and a soft surface, every layer count with both."""
    nw = 3
    B = nw * nG
    tau, w0, gt = _atm(B, nz, seed=40 + nG + nz)
    tau[2, 5] = 1e-7  # the thin-layer branch
    rng = np.random.default_rng(41)
    emis, bpl = rng.uniform(0.8, 1.0, B), rng.uniform(1e-2, 1.0, (B, nz + 1))
    wbin = np.polynomial.legendre.leggauss(nG)[1] / 2.0
    ref_args = lambda a: (*a[:4], hard, 1e-6, *a[4:])
    got = tc.ir_weighted_schedule_ref(*ref_args(T(tau, w0, gt, emis, bpl, wbin)))
    assert got[0].shape == (nw, nz + 1)
    kern = pts.two_stream_ir_weighted_pallas(*ref_args(J(tau, w0, gt, emis, bpl, wbin)))
    xla = _ir_weighted_xla(*ref_args(J(tau, w0, gt, emis, bpl, wbin)))
    _close(got, kern, RTOL_KERNEL, ATOL_KERNEL)
    _close(got, xla, RTOL_KERNEL, ATOL_KERNEL)


@pytest.mark.parametrize("with_amean", [True, False])
@pytest.mark.parametrize("nzen", [1, 4, 9, 12])
def test_solar_weighted_schedule_ref_matches_reference(interpret, nzen, with_amean):
    """The plain model of the weighted solar kernel's schedule (a thread per
    (row, zenith), back substitution fused with the edge fluxes, zenith then
    gauss reduction) against the JAX package's Pallas kernel in interpret
    mode and its XLA path, at every zenith count the kernel takes in one
    launch and past 8, with a thin layer."""
    nw, nG, nz = 3, 4, 17
    B = nw * nG
    tau, w0, gt = _atm(B, nz, seed=30 + nzen)
    tau[5, 3] = 1e-7
    rng = np.random.default_rng(31)
    u0s, rs = rng.uniform(0.2, 1.0, nzen), rng.uniform(0.0, 0.6, B)
    zw, wbin = rng.uniform(0.1, 0.5, nzen), np.polynomial.legendre.leggauss(nG)[1] / 2.0
    args = (tau, w0, gt, u0s, rs, zw, wbin)
    got = tc.solar_weighted_schedule_ref(*T(*args), with_amean=with_amean)
    assert got[1].shape == (nw, nz + 1) and (got[0] is None) == (not with_amean)
    kern = pts.two_stream_solar_multi_weighted_pallas(*J(*args), block_b=8,
                                                      with_amean=with_amean)
    xla = ref_ts.two_stream_solar_multi_weighted(*J(*args), with_amean=with_amean)
    _close(got, kern, RTOL_KERNEL, ATOL_KERNEL)
    _close(got, xla, RTOL_KERNEL, ATOL_KERNEL)


@pytest.mark.parametrize("size", [1, 5, 8])
def test_weighted_zenith_groups_sum_to_the_unsplit_solve(size):
    """The weighted solar kernel's zenith groups (past its block size), with
    the twin taking the launch's place: the groups' weighted outputs summed
    equal the unsplit twin's, the outputs being linear in zw."""
    nw, nG, nz, nzen = 3, 4, 13, 12
    tau, w0, gt = _atm(nw * nG, nz, seed=32)
    rng = np.random.default_rng(33)
    tt = T(tau, w0, gt, rng.uniform(0.2, 1.0, nzen), rng.uniform(0.0, 0.6, nw * nG),
           rng.uniform(0.1, 0.5, nzen), np.polynomial.legendre.leggauss(nG)[1] / 2.0)
    sizes = []

    def solve(u0_group, zw_group):
        sizes.append(u0_group.shape[0])
        return ts.two_stream_solar_multi_weighted(*tt[:3], u0_group, tt[4], zw_group, tt[6])

    got = tc._zenith_groups(solve, tt[3], size, zw=tt[5])
    assert sizes == [size] * (nzen // size) + [nzen % size] * (nzen % size > 0)
    _close(got, [x.numpy() for x in ts.two_stream_solar_multi_weighted(*tt)], 1e-13, 1e-15)


@pytest.mark.parametrize("hard", [True, False])
def test_unweighted_twins_match_reference(hard):
    B, nz = 19, 27
    tau, w0, gt = _atm(B, nz, seed=9)
    tau[3, 4] = 1e-7
    rng = np.random.default_rng(10)
    u0s = rng.uniform(0.2, 1.0, 3)
    u0 = rng.uniform(0.2, 1.0, B)
    rs = rng.uniform(0.0, 0.6, B)
    emis = np.full(B, 0.95)
    bpl = rng.uniform(1e-2, 1.0, (B, nz + 1))
    _close(ts.two_stream_solar_multi(*T(tau, w0, gt, u0s, rs)),
           ref_ts.two_stream_solar_multi(*J(tau, w0, gt, u0s, rs)), RTOL_TWIN, ATOL_TWIN)
    _close(ts.two_stream_solar(*T(tau, w0, gt, u0, rs)),
           ref_ts.two_stream_solar(*J(tau, w0, gt, u0, rs)), RTOL_TWIN, ATOL_TWIN)
    tt, jj = T(tau, w0, gt, emis, bpl), J(tau, w0, gt, emis, bpl)
    _close(ts.two_stream_ir(*tt[:4], hard, 1e-6, tt[4]),
           ref_ts.two_stream_ir(*jj[:4], hard, 1e-6, jj[4]), RTOL_TWIN, ATOL_TWIN)


@pytest.mark.parametrize("m", [1, 6, 13])
def test_block_pcr_matches_reference_and_thomas(m):
    """The twins' 2x2-block PCR against the reference's and against scalar
    Thomas on the interleaved tridiagonal system; multi-RHS per RHS."""
    rng = np.random.default_rng(11)
    B, nrhs = 5, 3
    L01, M01, U10 = (rng.uniform(0.1, 1.0, (B, m)) for _ in range(3))
    M00, M10, M11 = (rng.uniform(3.0, 5.0, (B, m)) for _ in range(3))
    M10 = rng.uniform(0.1, 1.0, (B, m))
    f0s, f1s = rng.uniform(-1, 1, (nrhs, B, m)), rng.uniform(-1, 1, (nrhs, B, m))
    comps = (L01, M00, M01, M10, M11, U10)
    u0s, u1s = tridiag.block2_pcr_components_multi(*T(*comps, f0s, f1s))
    for r in range(nrhs):
        want = ref_tridiag.block2_pcr_components(*J(*comps, f0s[r], f1s[r]))
        got = tridiag.block2_pcr_components(*T(*comps, f0s[r], f1s[r]))
        _close(got, want, 1e-12, 0.0)
        _close((u0s[r], u1s[r]), [g.numpy() for g in got], 1e-14, 0.0)
        # interleave into the scalar tridiagonal form: rows 2k, 2k+1
        n = 2 * m
        a = np.zeros((B, n)); b = np.zeros((B, n)); c = np.zeros((B, n)); d = np.zeros((B, n))
        a[:, 0::2], b[:, 0::2], c[:, 0::2], d[:, 0::2] = L01, M00, M01, f0s[r]
        a[:, 1::2], b[:, 1::2], c[:, 1::2], d[:, 1::2] = M10, M11, U10, f1s[r]
        x = tridiag.tridiag(*T(a.T, b.T, c.T, d.T)).numpy().T
        np.testing.assert_allclose(x[:, 0::2], got[0].numpy(), rtol=1e-11)
        np.testing.assert_allclose(x[:, 1::2], got[1].numpy(), rtol=1e-11)


def test_wrappers_never_hand_accelerator_tensors_to_the_twin():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    meta = lambda *shape: torch.empty(shape, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        tc.two_stream_ir_weighted_cuda(meta(8, 5), meta(8, 5), meta(8, 5), meta(8), True,
                                       1e-6, meta(8, 6), meta(8))
    with pytest.raises(ValueError):
        tc.two_stream_solar_multi_weighted_cuda(meta(8, 5), meta(8, 5), meta(8, 5), meta(2),
                                                meta(8), meta(2), meta(8))
    assert tc.two_stream_ir_weighted_cuda.launches == 0


@pytest.mark.parametrize("hard", [True, False])
def test_ir_auto_matches_pallas_kernel(interpret, hard):
    """two_stream_ir_auto on the CPU against the unreduced IR Pallas kernel
    (the JAX two_stream_ir_auto's TPU route), a thin layer included."""
    B, nz = 24, 17
    tau, w0, gt = _atm(B, nz, seed=12)
    tau[4, 3] = 1e-7
    rng = np.random.default_rng(13)
    emis, bpl = rng.uniform(0.8, 1.0, B), rng.uniform(1e-2, 1.0, (B, nz + 1))
    tt, jj = T(tau, w0, gt, emis, bpl), J(tau, w0, gt, emis, bpl)
    kern = pts.two_stream_ir_pallas(*jj[:4], hard, 1e-6, jj[4], block_b=8)
    got = tc.two_stream_ir_auto(*tt[:4], hard, 1e-6, tt[4])
    assert got[0].shape == (B, nz + 1)
    _close(got, kern, 1e-10, ATOL_KERNEL)
    _close(got, ref_ts.two_stream_ir_auto(*jj[:4], hard, 1e-6, jj[4]), RTOL_TWIN, ATOL_TWIN)


def test_solar_multi_auto_matches_pallas_kernel(interpret):
    """two_stream_solar_multi_auto (amean, surface radiance, fup, fdn per
    zenith) on the CPU against the unreduced multi-zenith Pallas kernel."""
    B, nz, nzen = 16, 19, 4
    tau, w0, gt = _atm(B, nz, seed=14)
    tau[1, 2] = 1e-7
    rng = np.random.default_rng(15)
    u0s, rs = rng.uniform(0.2, 1.0, nzen), rng.uniform(0.0, 0.6, B)
    kern = pts.two_stream_solar_multi_pallas(*J(tau, w0, gt, u0s, rs), block_b=8)
    got = tc.two_stream_solar_multi_auto(*T(tau, w0, gt, u0s, rs))
    assert got[1].shape == (nzen, B) and got[2].shape == (nzen, B, nz + 1)
    _close(got, kern, 1e-10, ATOL_KERNEL)


@pytest.mark.parametrize("nzen", [1, 4, 12])
def test_solar_rows_schedule_ref_matches_pallas_kernel(interpret, nzen):
    """The plain model of the unreduced multi-zenith solar kernel's schedule
    (a thread per (row, zenith), back substitution fused with the edge
    fluxes and the surface radiance) against the multi-zenith Pallas kernel
    in interpret mode, with a thin layer. Zenith cosines below 3**-0.5 keep
    1/u0^2 above every layer's lam^2 (< 3), away from the resonance of the
    solar source."""
    B, nz = 16, 19
    tau, w0, gt = _atm(B, nz, seed=50 + nzen)
    tau[3, 4] = 1e-7
    rng = np.random.default_rng(51)
    u0s, rs = rng.uniform(0.2, 0.55, nzen), rng.uniform(0.0, 0.6, B)
    kern = pts.two_stream_solar_multi_pallas(*J(tau, w0, gt, u0s, rs), block_b=8)
    got = tc.solar_rows_schedule_ref(*T(tau, w0, gt, u0s, rs))
    assert got[1].shape == (nzen, B) and got[0].shape == (nzen, B, nz + 1)
    _close(got, kern, 1e-10, ATOL_KERNEL)


def test_solar_auto_matches_pallas_kernel(interpret):
    """two_stream_solar_auto with one zenith cosine per row on the CPU against
    the single-zenith Pallas kernel, surface radiance included."""
    B, nz = 16, 23
    tau, w0, gt = _atm(B, nz, seed=16)
    rng = np.random.default_rng(17)
    u0, rs = rng.uniform(0.2, 1.0, B), rng.uniform(0.0, 0.6, B)
    kern = pts.two_stream_solar_pallas(*J(tau, w0, gt, u0, rs), block_b=8)
    got = tc.two_stream_solar_auto(*T(tau, w0, gt, u0, rs))
    assert got[1].shape == (B,) and got[3].shape == (B, nz + 1)
    _close(got, kern, 1e-10, ATOL_KERNEL)


@pytest.mark.parametrize("hard", [True, False])
def test_ir_rows_schedule_ref_matches_pallas_kernel(interpret, hard):
    """The plain model of the IR kernel's unreduced schedule (a thread per
    row, back substitution fused with the edge fluxes, the weighted IR
    kernel's forward and backward passes) against the unreduced IR Pallas
    kernel in interpret mode, a thin layer included."""
    B, nz = 24, 17
    tau, w0, gt = _atm(B, nz, seed=60)
    tau[4, 3] = 1e-7
    rng = np.random.default_rng(61)
    emis, bpl = rng.uniform(0.8, 1.0, B), rng.uniform(1e-2, 1.0, (B, nz + 1))
    tt, jj = T(tau, w0, gt, emis, bpl), J(tau, w0, gt, emis, bpl)
    kern = pts.two_stream_ir_pallas(*jj[:4], hard, 1e-6, jj[4], block_b=8)
    got = tc.ir_rows_schedule_ref(*tt[:4], hard, 1e-6, tt[4])
    assert got[0].shape == (B, nz + 1) and got[1].shape == (B, nz + 1)
    _close(got, kern, 1e-10, ATOL_KERNEL)


def test_solar_rows_schedule_ref_per_row_matches_pallas_kernel(interpret):
    """The plain model of the unreduced solar kernel's schedule with one
    zenith cosine per row against the single-zenith Pallas kernel in
    interpret mode, surface radiance and a thin layer included. The cosines
    vary per row below 3**-0.5, away from the resonance of the solar
    source."""
    B, nz = 16, 23
    tau, w0, gt = _atm(B, nz, seed=62)
    tau[5, 7] = 1e-7
    rng = np.random.default_rng(63)
    u0, rs = rng.uniform(0.2, 0.55, B), rng.uniform(0.0, 0.6, B)
    kern = pts.two_stream_solar_pallas(*J(tau, w0, gt, u0, rs), block_b=8)
    got = tc.solar_rows_schedule_ref(*T(tau, w0, gt, u0, rs), per_row=True)
    assert got[1].shape == (B,) and got[0].shape == (B, nz + 1)
    _close(got, kern, 1e-10, ATOL_KERNEL)


@pytest.mark.parametrize("nzen", [9, 12, 16])
def test_zenith_groups_match_the_unsplit_solve(nzen):
    """Zenith groups of 8 with per-zenith outputs, with the twin taking the
    launch's place: split and joined along the zenith axis, the outputs equal
    the unsplit twin's."""
    B, nz = 12, 15
    tau, w0, gt = _atm(B, nz, seed=20 + nzen)
    rng = np.random.default_rng(21)
    tt = T(tau, w0, gt, rng.uniform(0.2, 1.0, nzen), rng.uniform(0.0, 0.6, B))
    sizes = []

    def solve(u0_group):
        sizes.append(u0_group.shape[0])
        return ts.two_stream_solar_multi(*tt[:3], u0_group, tt[4])

    got = tc._zenith_groups(solve, tt[3], size=8)
    assert sizes == [8] * (nzen // 8) + [nzen % 8] * (nzen % 8 > 0)
    assert got[0].shape == (nzen, B, nz + 1) and got[1].shape == (nzen, B)
    _close(got, [x.numpy() for x in ts.two_stream_solar_multi(*tt)], 1e-13, 0.0)


def test_auto_dispatchers_never_hand_accelerator_tensors_to_the_twin():
    meta = lambda *shape: torch.empty(shape, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        tc.two_stream_ir_auto(meta(8, 5), meta(8, 5), meta(8, 5), meta(8), True, 1e-6,
                              meta(8, 6))
    with pytest.raises(ValueError):
        tc.two_stream_solar_multi_auto(meta(8, 5), meta(8, 5), meta(8, 5), meta(2), meta(8))
    with pytest.raises(ValueError):
        tc.two_stream_solar_auto(meta(8, 5), meta(8, 5), meta(8, 5), meta(8), meta(8))
    assert (tc.two_stream_ir_auto.launches, tc.two_stream_solar_multi_auto.launches,
            tc.two_stream_solar_auto.launches) == (0, 0, 0)
