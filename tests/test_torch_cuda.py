"""The port's CUDA kernels against their plain twins on the card (float64,
RORR and the weighted kernels also in float32, RORR on ties; small shapes),
the nbin > 16 RORR routing, AdiabatClimate on the card, the RCE path's
pieces (the batched IR call, the RC march's cached CUDA graph, per batch
size), the five batched column solves and the batched device RCE against the
port on the CPU. Skipped where no
CUDA device is present; on a GPU machine:
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`` (the
suite's conftest configures JAX, which a GPU machine need not have)."""

import dataclasses
import json
from unittest import mock

import numpy as np
import pytest
import torch

from clima_tpu_torch.adiabat import AdiabatClimate, profile_rc, rce, rce_device
from clima_tpu_torch.data import make_template
from clima_tpu_torch.ops import rorr, rorr_cuda, twostream, twostream_cuda
from clima_tpu_torch.ops.cuda_graph import CAPTURES
from clima_tpu_torch.parallel import (batched_make_column, batched_make_profile_bg_gas,
                                      batched_surface_temperature,
                                      batched_surface_temperature_bg_gas,
                                      batched_surface_temperature_column,
                                      batched_surface_temperature_trop, batched_toa_fluxes)
from clima_tpu_torch.physics import eqns
from clima_tpu_torch.radtran import opacity, radiate
from clima_tpu_torch.radtran.opacity import _rorr_mix

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _atm(B, nz, dev, seed):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.tensor(x, device=dev)
    tau = rng.uniform(1e-6, 2.0, (B, nz))
    tau[2, 5] = 1e-7
    return t(tau), t(rng.uniform(0.02, 0.999, (B, nz))), t(rng.uniform(0.0, 0.85, (B, nz)))


def _close(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-9, atol=1e-12)


def _planck_rows(nw, nG, nz, rng):
    """(nw * nG, nz + 1) Planck values as the radiate module forms them: per
    gauss group one frequency and a 290 -> 180 K column, jittered."""
    T_col = np.linspace(290.0, 180.0, nz + 1)[None, :] + rng.uniform(-5.0, 5.0, (nw, 1))
    freq = 10.0 ** rng.uniform(12.5, 14.0, (nw, 1))
    return np.repeat(eqns.planck_fcn(torch.tensor(freq), torch.tensor(T_col)).numpy(), nG, axis=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nz", [21, 37, 202])
@pytest.mark.parametrize("nG", [1, 4, 8, 16])
@pytest.mark.parametrize("hard", [True, False])
def test_ir_weighted_kernel_matches_twin(dev, hard, nG, nz, dtype):
    """128 // nG + 3 gauss groups, so the last block of whole groups (128
    threads) is partial, with a thin layer; two calls give bitwise equal
    outputs. float64: random Planck values, rtol 1e-9. float32: the Planck
    function of a temperature column, held at 1e-4 of the largest value (with
    random Planck values the linear-in-tau source of thin layers cancels in
    float32, in the twin alike, up to ~4e-4 of the largest value)."""
    nw = 128 // nG + 3
    tau, w0, gt = _atm(nw * nG, nz, dev, 7)
    rng = np.random.default_rng(8)
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    emis = rng.uniform(0.8, 1.0, nw * nG)
    bpl = rng.uniform(1e-2, 1.0, (nw * nG, nz + 1)) if dtype == torch.float64 else \
        _planck_rows(nw, nG, nz, rng)
    args = (tau.to(dtype), w0.to(dtype), gt.to(dtype), t(emis), hard, 1e-6, t(bpl),
            t(np.polynomial.legendre.leggauss(nG)[1] / 2.0))
    n = twostream_cuda.two_stream_ir_weighted_cuda.launches
    got = twostream_cuda.two_stream_ir_weighted_cuda(*args)
    assert twostream_cuda.two_stream_ir_weighted_cuda.launches == n + 1
    assert got[0].dtype == dtype and got[0].shape == (nw, nz + 1)
    again = twostream_cuda.two_stream_ir_weighted_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = twostream.two_stream_ir_weighted(*args)
    (_close if dtype == torch.float64 else _close_f32)(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ir_weighted_kernel_large_gauss_group(dev, dtype):
    """Gauss groups of 384 rows, a block each: in float64 the kernel's tiles
    of 8 layers do not fit in shared memory there, so it takes shallower
    ones (4 layers). Tolerances as in test_ir_weighted_kernel_matches_twin."""
    nw, nG, nz = 3, 384, 37
    tau, w0, gt = _atm(nw * nG, nz, dev, 19)
    rng = np.random.default_rng(20)
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    emis = rng.uniform(0.8, 1.0, nw * nG)
    bpl = rng.uniform(1e-2, 1.0, (nw * nG, nz + 1)) if dtype == torch.float64 else \
        _planck_rows(nw, nG, nz, rng)
    for hard in (True, False):
        args = (tau.to(dtype), w0.to(dtype), gt.to(dtype), t(emis), hard, 1e-6, t(bpl),
                t(np.polynomial.legendre.leggauss(nG)[1] / 2.0))
        n = twostream_cuda.two_stream_ir_weighted_cuda.launches
        got = twostream_cuda.two_stream_ir_weighted_cuda(*args)
        assert twostream_cuda.two_stream_ir_weighted_cuda.launches == n + 1
        (_close if dtype == torch.float64 else _close_f32)(
            got, twostream.two_stream_ir_weighted(*args))


def _close_f32(got, want):
    """float32: the largest error under 1e-4 of the largest value."""
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g, w = g.double().cpu().numpy(), w.double().cpu().numpy()
        assert np.isfinite(g).all() and np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nzen", [1, 3, 4, 6, 9, 12, 16])
@pytest.mark.parametrize("with_amean", [True, False])
def test_solar_multi_weighted_kernel_matches_twin(dev, with_amean, nzen, dtype):
    """7 gauss groups of 4 rows, which fill no block of whole groups (32, 10,
    8, 5, 3, 2 and 2 groups per block at these zenith counts). float64:
    random zenith cosines, rtol 1e-9. float32: the Gauss zenith nodes, since
    random ones meet the lam^2 = 1/u0^2 resonance of the solar source (a
    fault of the reference's formulation), held at 1e-4 of the largest
    value."""
    nw, nG, nz = 7, 4, 33
    tau, w0, gt = _atm(nw * nG, nz, dev, 5)
    rng = np.random.default_rng(6)
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    if dtype == torch.float64:
        u0s, rs, zw = rng.uniform(0.2, 1.0, nzen), rng.uniform(0.0, 0.6, nw * nG), \
            rng.uniform(0.1, 0.5, nzen)
    else:
        ang, zw = eqns.zenith_angles_and_weights(nzen)
        u0s, rs = np.cos(np.asarray(ang) * np.pi / 180.0), rng.uniform(0.0, 0.6, nw * nG)
    args = (tau.to(dtype), w0.to(dtype), gt.to(dtype), t(u0s), t(rs), t(zw),
            t(np.polynomial.legendre.leggauss(nG)[1] / 2.0))
    n = twostream_cuda.two_stream_solar_multi_weighted_cuda.launches
    got = twostream_cuda.two_stream_solar_multi_weighted_cuda(*args, with_amean=with_amean)
    assert twostream_cuda.two_stream_solar_multi_weighted_cuda.launches == n + 1
    assert got[1].dtype == dtype and got[1].shape == (nw, nz + 1)
    want = twostream.two_stream_solar_multi_weighted(*args, with_amean=with_amean)
    (_close if dtype == torch.float64 else _close_f32)(got, want)


@pytest.mark.parametrize("with_amean", [True, False])
def test_solar_multi_weighted_kernel_splits_zenith_groups(dev, with_amean):
    """128 gauss rows x 9 zeniths = 1152 threads per group, past any block:
    the zeniths run in groups, one launch each, and the groups' weighted
    outputs are summed."""
    nw, nG, nz, nzen = 3, 128, 17, 9
    tau, w0, gt = _atm(nw * nG, nz, dev, 17)
    rng = np.random.default_rng(18)
    t = lambda x: torch.tensor(x, device=dev)
    args = (tau, w0, gt, t(rng.uniform(0.2, 1.0, nzen)), t(rng.uniform(0.0, 0.6, nw * nG)),
            t(rng.uniform(0.1, 0.5, nzen)), t(np.polynomial.legendre.leggauss(nG)[1] / 2.0))
    per = twostream_cuda._solar_max_group(True, with_amean) // nG
    n = twostream_cuda.two_stream_solar_multi_weighted_cuda.launches
    _close(twostream_cuda.two_stream_solar_multi_weighted_cuda(*args, with_amean=with_amean),
           twostream.two_stream_solar_multi_weighted(*args, with_amean=with_amean))
    launches = twostream_cuda.two_stream_solar_multi_weighted_cuda.launches - n
    assert launches == -(-nzen // per) and launches >= 2


@pytest.mark.parametrize("nbin", [3, 8, 12, 16])
def test_rorr_kernel_matches_twin(dev, nbin):
    rng = np.random.default_rng(5)
    t = lambda x: torch.tensor(x, device=dev)
    tks = t(10 ** rng.uniform(-6, 1, (3, nbin, 777)))
    w = rng.uniform(0.5, 1.5, nbin)
    wbin = w / w.sum()
    wbin_e = t(np.concatenate([[0.0], np.cumsum(wbin)]))
    got = rorr_cuda.k_rorr_mix_cuda(tks, t(wbin), wbin_e)
    want = rorr.k_rorr_mix(tks.movedim(1, -1), wbin_e).movedim(-1, 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-9)


def _rorr_case(case, nbin, R, dtype, rng):
    """(nk=3, nbin, R) inputs of one tie or type case."""
    tks = 10 ** rng.uniform(-6, 1, (3, nbin, R))
    if case == "equal":  # every lane's nbin^2 keys equal at each species
        tks = np.broadcast_to(np.array([0.25, 0.5, 0.125])[:, None, None], tks.shape).copy()
    elif case == "rounded":  # a[i] + b[j] equal for all i only after rounding
        eps = np.finfo(np.float32 if dtype == torch.float32 else np.float64).eps
        tks[0] = 1.0 + np.arange(nbin)[:, None] * eps
        tks[1] = 64.0 + np.arange(nbin)[:, None]
        tks[:2] *= 2.0 ** rng.integers(-3, 4, R)  # exact per-lane scale
    elif case == "zeros":  # zero lanes, a zero species, zero keys
        tks[:, :, ::5] = 0.0
        tks[1, :, 1::5] = 0.0
        tks[0, : (nbin + 1) // 2, 2::5] = 0.0
    return tks


@pytest.mark.parametrize("case", ["random", "equal", "rounded", "zeros"])
@pytest.mark.parametrize("nbin", [1, 2, 3, 8, 12, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rorr_kernel_ties_and_types(dev, dtype, nbin, case):
    """The kernel against its twin on ties, zeros and both types, at an R
    that is no multiple of any instance's lanes per block (8, 32 or 64 lanes
    of 256 threads). float64: rtol 1e-9. float32: the largest error under
    1e-4 of the largest value (the twin's edge differences round in float32)."""
    rng = np.random.default_rng(nbin)
    R = 1001
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    tks = t(_rorr_case(case, nbin, R, dtype, rng))
    w = rng.uniform(0.5, 1.5, nbin)
    wbin = w / w.sum()
    wbin_e = t(np.concatenate([[0.0], np.cumsum(wbin)]))
    n = rorr_cuda.k_rorr_mix_cuda.launches
    got = rorr_cuda.k_rorr_mix_cuda(tks, t(wbin), wbin_e)
    assert rorr_cuda.k_rorr_mix_cuda.launches == n + 1 and got.dtype == dtype
    want = rorr.k_rorr_mix(tks.movedim(1, -1), wbin_e).movedim(-1, 0)
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.isfinite(got).all()
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0.0)
    else:
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_rorr_past_nbin_16_runs_on_the_card(dev):
    """nbin > 16 takes the sort path on the card's own tensors, with the
    reference's warning, over several lane chunks (the bound patched to 32
    lanes of 400 pair keys), and matches the CPU result."""
    rng = np.random.default_rng(9)
    nbin = 20
    tks = 10 ** rng.uniform(-6, 1, (3, nbin, 77))
    w = rng.uniform(0.5, 1.5, nbin)
    wbin = w / w.sum()
    wbin_e = np.concatenate([[0.0], np.cumsum(wbin)])
    with pytest.warns(UserWarning, match="nbin=20 > 16"), \
            mock.patch.object(opacity, "_SORT_CHUNK_KEYS", 32 * nbin * nbin):
        got = _rorr_mix(*(torch.tensor(x, device=dev) for x in (tks, wbin, wbin_e)))
    assert got.device == dev
    with pytest.warns(UserWarning, match="nbin=20 > 16"):
        want = _rorr_mix(*(torch.tensor(x) for x in (tks, wbin, wbin_e)))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12)


# (rows, nz) of the unreduced kernels' card tests: rows not a multiple of 32
# or of a block (128), one layer, odd layer counts, and layer counts around
# the kernels' 8-layer input tiles and the edges they stage per store (8 for
# #4; 16 float64, 32 float32 for #6)
UNREDUCED_SHAPES = [(300, 29), (45, 1), (129, 17), (96, 202), (33, 31)]


def _atm_thin(rows, nz, dev, seed, dtype):
    """Random optical properties in the JAX kernel tests' ranges, with a
    thin layer (tau 1e-7) at row min(2, rows - 1), layer min(5, nz - 1)."""
    rng = np.random.default_rng(seed)
    tau = rng.uniform(1e-6, 2.0, (rows, nz))
    tau[min(2, rows - 1), min(5, nz - 1)] = 1e-7
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    return t(tau), t(rng.uniform(0.02, 0.999, (rows, nz))), t(rng.uniform(0.0, 0.85, (rows, nz)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows, nz", UNREDUCED_SHAPES)
@pytest.mark.parametrize("hard", [True, False])
def test_ir_auto_kernel_matches_twin(dev, hard, rows, nz, dtype):
    """The unreduced IR solve (the weighted IR kernel at nG = 1) against the
    twin and the plain model of its schedule, one launch, two calls bitwise
    equal. float64:
    random Planck values, rtol 1e-9. float32: the Planck function of a
    temperature column, held to the float64 twin on the same inputs, each
    output within twice the float32 twin's own largest deviation from it or
    1e-5 of its largest value: per row, the linear-in-tau source of a layer
    just above tau_min cancels in float32, in the twin alike (ROADMAP Queue
    3; 1.8e-4 of the largest value at 300 x 29), where a gauss sum would
    average it out."""
    tau, w0, gt = _atm_thin(rows, nz, dev, 11 + nz, dtype)
    rng = np.random.default_rng(12)
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    bpl = rng.uniform(1e-2, 1.0, (rows, nz + 1)) if dtype == torch.float64 else \
        _planck_rows(rows, 1, nz, rng)
    args = (tau, w0, gt, t(rng.uniform(0.8, 1.0, rows)), hard, 1e-6, t(bpl))
    n = twostream_cuda.two_stream_ir_auto.launches
    got = twostream_cuda.two_stream_ir_auto(*args)
    assert twostream_cuda.two_stream_ir_auto.launches == n + 1
    assert got[0].dtype == dtype and got[0].shape == (rows, nz + 1)
    again = twostream_cuda.two_stream_ir_auto(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if dtype == torch.float64:
        _close(got, twostream.two_stream_ir(*args))
        _close(got, twostream_cuda.ir_rows_schedule_ref(*args))
        return
    want = twostream.two_stream_ir(*[a.double() if torch.is_tensor(a) else a for a in args])
    for g, own, w in zip(got, twostream.two_stream_ir(*args), want):
        err, own_err = (g.double() - w).abs().max(), (own.double() - w).abs().max()
        assert bool(torch.isfinite(g).all())
        assert err <= max(2.0 * own_err, 1e-5 * w.abs().max()), (float(err), float(own_err))


@pytest.mark.parametrize("nzen", [1, 4, 7, 9, 12, 16, 33])
def test_solar_multi_auto_kernel_matches_twin(dev, nzen):
    """300 rows: the last block of 128 (row, zenith) pairs is partial, and
    at most zenith counts a row's zeniths straddle two blocks. One launch at
    every zenith count."""
    rows, nz = 300, 31
    tau, w0, gt = _atm(rows, nz, dev, 13)
    rng = np.random.default_rng(14)
    t = lambda x: torch.tensor(x, device=dev)
    args = (tau, w0, gt, t(rng.uniform(0.2, 1.0, nzen)), t(rng.uniform(0.0, 0.6, rows)))
    n = twostream_cuda.two_stream_solar_multi_auto.launches
    got = twostream_cuda.two_stream_solar_multi_auto(*args)
    assert twostream_cuda.two_stream_solar_multi_auto.launches == n + 1
    assert got[0].shape == (nzen, rows, nz + 1) and got[1].shape == (nzen, rows)
    _close(got, twostream.two_stream_solar_multi(*args))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nz", [1, 16, 17, 202])
def test_solar_multi_auto_kernel_matches_schedule_ref(dev, nz, dtype):
    """The kernel against the plain model of its schedule and against the
    twin, on inputs away from the lam^2 = 1/u0^2 resonance (zenith cosines
    below 3**-0.5), at layer counts around the 16 float64 / 32 float32 edges
    a warp stages: float64 at rtol 1e-9, float32 at 1e-4 of the largest
    value; two calls give bitwise equal outputs."""
    rows, nzen = 200, 5
    tau, w0, gt = _atm(rows, max(nz, 6), dev, 21)
    rng = np.random.default_rng(22)
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    args = (tau[:, :nz].contiguous().to(dtype), w0[:, :nz].contiguous().to(dtype),
            gt[:, :nz].contiguous().to(dtype), t(rng.uniform(0.2, 0.55, nzen)),
            t(rng.uniform(0.0, 0.6, rows)))
    got = twostream_cuda.two_stream_solar_multi_auto(*args)
    assert got[2].dtype == dtype
    again = twostream_cuda.two_stream_solar_multi_auto(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    close = _close if dtype == torch.float64 else _close_f32
    close(got, twostream_cuda.solar_rows_schedule_ref(*args))
    close(got, twostream.two_stream_solar_multi(*args))


@pytest.fixture(scope="module")
def parent_build():
    """The parent commit's csrc/twostream.cu (its path in
    TWOSTREAM_PARENT_SOURCE), built once: its entry points."""
    import os

    from clima_tpu_torch.tools import compare_twostream_builds as builds

    parent = os.environ.get("TWOSTREAM_PARENT_SOURCE")
    if not parent:
        pytest.skip("set TWOSTREAM_PARENT_SOURCE to the parent commit's csrc/twostream.cu")
    return builds.build("parent", parent)[0]


def _against_parent(parent_build, wrapper, args):
    """``wrapper(*args)`` built from this checkout and from the parent
    commit: bitwise equal, or the largest difference printed and within rtol
    1e-9, atol 1e-12."""
    from clima_tpu_torch.tools import compare_twostream_builds as builds

    with builds.using(parent_build):
        want = wrapper(*args)
    got = wrapper(*args)
    diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"largest difference from the parent build: {diff:.3e}")
    if diff > 0:
        _close(got, want)


def test_solar_multi_auto_matches_the_parent_build(dev, parent_build):
    """#5 from this checkout and from the parent commit, 4 zenith angles in
    one launch, on the same inputs."""
    rows, nz = 1000, 61
    tau, w0, gt = _atm(rows, nz, dev, 23)
    rng = np.random.default_rng(24)
    t = lambda x: torch.tensor(x, device=dev)
    args = (tau, w0, gt, t(rng.uniform(0.2, 1.0, 4)), t(rng.uniform(0.0, 0.6, rows)))
    _against_parent(parent_build, twostream_cuda.two_stream_solar_multi_auto, args)


@pytest.mark.parametrize("hard", [True, False])
def test_ir_auto_matches_the_parent_build(dev, parent_build, hard):
    """#4 from this checkout and from the parent commit (the thread-per-row
    template, where the build still has it) on the same inputs."""
    rows, nz = 1000, 61
    tau, w0, gt = _atm(rows, nz, dev, 25)
    rng = np.random.default_rng(26)
    t = lambda x: torch.tensor(x, device=dev)
    args = (tau, w0, gt, t(rng.uniform(0.8, 1.0, rows)), hard, 1e-6,
            t(rng.uniform(1e-2, 1.0, (rows, nz + 1))))
    _against_parent(parent_build, twostream_cuda.two_stream_ir_auto, args)


def test_solar_auto_matches_the_parent_build(dev, parent_build):
    """#6 from this checkout and from the parent commit (the thread-per-row
    template, where the build still has it) on the same inputs, one zenith
    cosine per row off the resonance."""
    rows, nz = 1000, 61
    tau, w0, gt = _atm(rows, nz, dev, 27)
    rng = np.random.default_rng(28)
    t = lambda x: torch.tensor(x, device=dev)
    args = (tau, w0, gt, t(rng.uniform(0.2, 0.55, rows)), t(rng.uniform(0.0, 0.6, rows)))
    _against_parent(parent_build, twostream_cuda.two_stream_solar_auto, args)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows, nz", UNREDUCED_SHAPES)
def test_solar_auto_kernel_matches_twin(dev, rows, nz, dtype):
    """The single-zenith solar kernel (one zenith cosine per row) against the
    twin and the plain model of its schedule, one launch, two calls bitwise
    equal. The cosines vary per row below 3**-0.5, away from the lam^2 =
    1/u0^2 resonance of the solar source. float64 at rtol 1e-9, float32 at
    1e-4 of the largest value."""
    tau, w0, gt = _atm_thin(rows, nz, dev, 15 + nz, dtype)
    rng = np.random.default_rng(16)
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    args = (tau, w0, gt, t(rng.uniform(0.2, 0.55, rows)), t(rng.uniform(0.0, 0.6, rows)))
    n = twostream_cuda.two_stream_solar_auto.launches
    got = twostream_cuda.two_stream_solar_auto(*args)
    assert twostream_cuda.two_stream_solar_auto.launches == n + 1
    assert got[0].shape == (rows, nz + 1) and got[1].shape == (rows,)
    assert got[2].dtype == dtype
    again = twostream_cuda.two_stream_solar_auto(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    close = _close if dtype == torch.float64 else _close_f32
    close(got, twostream.two_stream_solar(*args))
    close(got, twostream_cuda.solar_rows_schedule_ref(*args, per_row=True))


def test_adiabat_climate_on_the_card_matches_the_cpu(dev):
    """AdiabatClimate on the card (graph-replayed march, kernels) against the port
    on the CPU: TOA fluxes and the profile state, nz=12."""
    tpl = make_template(nz=12, n_zenith=2)
    files = (tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"])
    gpu, cpu = AdiabatClimate(*files, substeps=2), AdiabatClimate(*files, substeps=2, device="cpu")
    assert gpu.device.type == "cuda"
    P_i = np.full(gpu.sp.ng, 1e-15)
    P_i[gpu.species_names.index("H2O")] = 270e6
    P_i[gpu.species_names.index("CO2")] = 400.0
    P_i[gpu.species_names.index("N2")] = 1e6
    np.testing.assert_allclose(gpu.TOA_fluxes(285.0, P_i), cpu.TOA_fluxes(285.0, P_i), rtol=1e-9)
    for k in ("P", "T", "z", "f_i", "N_atmos"):
        np.testing.assert_allclose(getattr(gpu, k), getattr(cpu, k), rtol=1e-10, err_msg=k)


def _rce_model(nz=20):
    tpl = make_template(nz=nz, n_zenith=1, surface_albedo=0.3)
    c = AdiabatClimate(tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"], substeps=2)
    c.verbose = False
    P_i = np.full(c.sp.ng, 1e-15)
    P_i[c.species_names.index("H2O")] = 270e6
    P_i[c.species_names.index("CO2")] = 400.0
    P_i[c.species_names.index("N2")] = 1e6
    return c, P_i


def test_ir_fluxes_batch_matches_twin(dev):
    """The RCE Jacobian's batched IR call at n = 21 columns through the IR
    kernel (#1), against the same call with the kernel swapped for its twin:
    rtol 1e-9 and an atol of 1e-10 of the largest flux, since the downward
    flux falls to ~0 at the top, below the roundoff of sums over the
    ~1e5-sized fluxes (chip_smoke.py's compare_fluxes)."""
    c, P_i = _rce_model()
    c.TOA_fluxes(285.0, P_i)  # opacities of this column, frozen below
    rng = np.random.default_rng(23)
    T_r, *_ = c.copy_atm_to_radiative_grid()
    T_surf = 285.0 + rng.uniform(-3.0, 3.0, 21)
    T = T_r[None, :] + rng.uniform(-3.0, 3.0, (21, T_r.shape[0]))
    n = twostream_cuda.two_stream_ir_weighted_cuda.launches
    got = c.rad.ir_fluxes_batch(T_surf, T)
    assert twostream_cuda.two_stream_ir_weighted_cuda.launches == n + 1
    assert got[0].shape == (21, c.nz_r + 1)
    with mock.patch.object(radiate, "two_stream_ir_weighted_cuda",
                           twostream.two_stream_ir_weighted):
        want = c.rad.ir_fluxes_batch(T_surf, T)
    assert twostream_cuda.two_stream_ir_weighted_cuda.launches == n + 1
    for g, w in zip(got, want):
        w = w.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=1e-9, atol=1e-10 * np.abs(w).max())


def _rc_inputs(c, P_i, masks, T_tops):
    """make_profile_rc_core's arguments for a batch of columns, one per
    (mask, T_top): T linear from 285 K to T_top."""
    t = c._tensor
    T_in = np.array([np.linspace(285.0, T_top, c.nz + 1) for T_top in T_tops])
    return (dataclasses.replace(c._par, P_top=float(c.P_top)), t(c.RH), t(T_in[:, 0]),
            t(T_in[:, 1:]), t(np.repeat(P_i[None], len(T_tops), 0)),
            torch.as_tensor(np.array(masks), device=c.device), rce._custom_mix(c))


RC_COLUMNS = [(np.arange(20) < 6, 190.0), (np.zeros(20, bool), 210.0),
              ((np.arange(20) < 3) | (np.arange(20) >= 15), 200.0), (np.arange(20) < 12, 185.0)]


def test_rc_march_graphed_matches_eager(dev):
    """make_profile_rc_core on the card replaying the captured interval
    against the same march run eagerly on the card, rtol 1e-12, over a batch
    of four columns with their own masks."""
    c, P_i = _rce_model()
    args = _rc_inputs(c, P_i, *zip(*RC_COLUMNS))
    got = profile_rc.make_profile_rc_core(*args, graphs={})
    with mock.patch.object(profile_rc, "graphed", lambda fn, *a: (fn, fn(*a))):
        want = profile_rc.make_profile_rc_core(*args)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].cpu().numpy(), w.cpu().numpy(), rtol=1e-12,
                                   atol=1e-300, err_msg=k)


def test_rc_graph_captured_once_per_shape(dev):
    """Two masks and two temperature profiles through make_profile_rc: one
    capture of the RC interval, cached on the model; each result matches the
    port on the CPU at rtol 1e-10."""
    c, P_i = _rce_model()
    tpl = make_template(nz=20, n_zenith=1, surface_albedo=0.3)
    cpu = AdiabatClimate(tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"],
                         substeps=2, device="cpu")
    n = CAPTURES.get("_rc_interval", 0)
    for mask in (np.arange(c.nz) < 6, (np.arange(c.nz) < 3) | (np.arange(c.nz) >= 15)):
        for T_top in (190.0, 210.0):
            T_in = np.linspace(285.0, T_top, c.nz + 1)
            for m in (c, cpu):
                m._set_convecting_zones(mask)
                m.make_profile_rc(P_i, T_in)
            for k in ("P", "T", "z", "f_i", "lapse_rate"):
                np.testing.assert_allclose(getattr(c, k), getattr(cpu, k), rtol=1e-10, err_msg=k)
    assert CAPTURES.get("_rc_interval", 0) == n + 1
    assert len(c._rc_graphs) == 1


def test_rc_march_batch_matches_single_columns(dev):
    """The RC march at B=1 and then at B=4, through one graph cache, against
    B=1 runs of each column (rtol 1e-10): a graph captured at one batch size
    must not replay on another's buffers, so the cache holds one capture per
    batch size."""
    c, P_i = _rce_model()
    graphs = {}
    n = CAPTURES.get("_rc_interval", 0)
    singles = [profile_rc.make_profile_rc_core(*_rc_inputs(c, P_i, [mask], [T_top]),
                                               graphs=graphs) for mask, T_top in RC_COLUMNS]
    batch = profile_rc.make_profile_rc_core(*_rc_inputs(c, P_i, *zip(*RC_COLUMNS)),
                                            graphs=graphs)
    assert CAPTURES.get("_rc_interval", 0) == n + 2
    assert sorted(key[0] for key in graphs) == [1, len(RC_COLUMNS)]
    for b, one in enumerate(singles):
        for k, w in one.items():
            np.testing.assert_allclose(batch[k][b].cpu().numpy(), w[0].cpu().numpy(),
                                       rtol=1e-10, atol=1e-300, err_msg=f"{k} column {b}")


def _device_rce_lanes(c):
    """Two lanes (CO2 400 and 800) warm-started from surface_temperature."""
    P_i = np.full((2, c.sp.ng), 1e-15)
    P_i[:, c.species_names.index("H2O")] = 270e6
    P_i[:, c.species_names.index("CO2")] = [400.0, 800.0]
    P_i[:, c.species_names.index("N2")] = 1e6
    T_surf = c.surface_temperature(P_i[0], T_guess=280.0)
    return P_i, np.full(2, T_surf), np.repeat(c.T[None], 2, 0)


def test_device_rce_on_the_card_matches_the_cpu_rebuild(dev):
    """batched_rce on the card (nz=8, B=2): every lane status 0; at its final
    state the port's objective on the CPU gives the same profile (rtol 1e-9),
    f_total (rtol 1e-9 of the flux scale) and max|F/F0| < xtol_rc."""
    tpl = make_template(nz=8, n_zenith=2, surface_albedo=0.3)
    files = (tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"])
    gpu, cpu = AdiabatClimate(*files, substeps=2), AdiabatClimate(*files, substeps=2, device="cpu")
    P_i, T_surf, T = _device_rce_lanes(gpu)
    out = rce_device.batched_rce(gpu, P_i, T_surf, T)
    assert out["T"].device.type == "cuda"
    assert (out["status"] == 0).all() and (out["max_ratio"] < gpu.xtol_rc).all()
    x = torch.cat([out["T_surf"][:, None], out["T"]], dim=1).cpu()
    mask = out["convecting_with_below"].cpu()
    xm, dFdt, _, aux = rce_device.build_rce_fns(cpu)["objective"](x, mask, cpu._tensor(P_i))
    np.testing.assert_allclose(out["T"].cpu().numpy(), xm[:, 1:].numpy(), rtol=1e-9)
    for k, v in (("P", aux["P_c"]), ("z", aux["z"]), ("P_surf", aux["P_surf"])):
        np.testing.assert_allclose(out[k].cpu().numpy(), v.numpy(), rtol=1e-9, err_msg=k)
    f_total = aux["f_total"].numpy()
    np.testing.assert_allclose(out["f_total"].cpu().numpy(), f_total, rtol=1e-9,
                               atol=1e-9 * np.abs(f_total).max())
    ratio = np.abs(dFdt.numpy()).max(axis=1) * 1e-3 / (gpu.rad.bolometric_flux() / 4.0)
    assert (ratio < cpu.xtol_rc).all(), ratio


def test_card_tensors_are_accepted_as_inputs(dev):
    """The port's outputs on the card go back in as inputs: batched_toa_fluxes
    on batched_surface_temperature's T_surf, and batched_rce (B=2) restarted
    from its own converged result, every lane of the restart status 0."""
    tpl = make_template(nz=8, n_zenith=2, surface_albedo=0.3)
    c = AdiabatClimate(tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"], substeps=2)
    P_i, T_surf, T = _device_rce_lanes(c)
    T_s, _, conv, _ = batched_surface_temperature(c, P_i)
    assert T_s.device.type == "cuda" and bool(conv.all())
    isr, olr = batched_toa_fluxes(c, T_s, torch.as_tensor(P_i, device=dev))
    assert isr.device.type == "cuda"
    np.testing.assert_allclose(isr.cpu().numpy(), olr.cpu().numpy(), rtol=1e-5)
    out = rce_device.batched_rce(c, P_i, T_surf, T)
    assert (out["status"] == 0).all()
    again = rce_device.batched_rce(c, torch.as_tensor(P_i, device=dev), out["T_surf"], out["T"],
                                   out["convecting_with_below"])
    assert again["T"].device.type == "cuda" and (again["status"] == 0).all()
    np.testing.assert_allclose(again["T_surf"].cpu().numpy(), out["T_surf"].cpu().numpy(),
                               rtol=1e-4)


def test_device_rce_objective_launches_the_kernels_not_the_twins(dev):
    """One objective of the device RCE on the card launches RORR, #1 and #2
    once each, and no plain twin runs."""
    c, P_i = _rce_model(nz=8)
    fns = rce_device.build_rce_fns(c)
    T_in = np.linspace(285.0, 200.0, c.nz + 1)
    args = (c._tensor(T_in[None]), torch.as_tensor(np.arange(c.nz)[None] < 3, device=dev),
            c._tensor(P_i[None]))

    def refuse(*args, **kwargs):
        raise AssertionError("a plain twin ran on the card")

    before = [w.launches for w in KERNEL_WRAPPERS]
    with mock.patch.object(rorr_cuda, "k_rorr_mix", refuse), \
            mock.patch.object(twostream_cuda.ts, "two_stream_ir_weighted", refuse), \
            mock.patch.object(twostream_cuda.ts, "two_stream_solar_multi_weighted", refuse):
        _, dFdt, _, _ = fns["objective"](*args)
    assert [w.launches - n for w, n in zip(KERNEL_WRAPPERS, before)] == [1, 1, 1]
    assert bool(torch.isfinite(dFdt).all())


@pytest.fixture(scope="module")
def solver_models():
    """The nz=8, 2-zenith model at substeps=2 on the card and on the CPU, B=2
    columns (H2O 270 bar, CO2 300 and 600, N2 1 bar)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tpl = make_template(nz=8, n_zenith=2)
    files = (tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"])
    gpu, cpu = AdiabatClimate(*files, substeps=2), AdiabatClimate(*files, substeps=2, device="cpu")
    P_i = np.full((2, cpu.sp.ng), 1e-15)
    P_i[:, cpu.species_names.index("H2O")] = 270e6
    P_i[:, cpu.species_names.index("CO2")] = [300.0, 600.0]
    P_i[:, cpu.species_names.index("N2")] = 1e6
    return gpu, cpu, P_i


def _inventories(c, P_i, T_surf, factors):
    c.make_profile(T_surf, P_i[0])
    return np.outer(factors, c.N_atmos + c.N_surface)


SOLVES = {
    "make_column": (lambda c, cpu, P: batched_make_column(
        c, [280.0, 280.0], _inventories(cpu, P, 280.0, [1.0, 1.1])), ["P_i_surf"]),
    "make_profile_bg_gas": (lambda c, cpu, P: batched_make_profile_bg_gas(
        c, [280.0, 280.0], P, [1e6, 2e6], "N2"), ["P_i_surf"]),
    "surface_temperature_trop": (lambda c, cpu, P: batched_surface_temperature_trop(
        c, P, T_guess=260.0), ["T_surf", "T_trop"]),
    "surface_temperature_column": (lambda c, cpu, P: batched_surface_temperature_column(
        c, _inventories(cpu, P, 259.0, [1.0, 1.05]), T_guess=259.0), ["T_surf", "P_i_surf"]),
    "surface_temperature_bg_gas": (lambda c, cpu, P: batched_surface_temperature_bg_gas(
        c, P, [1e6, 2e6], "N2", T_guess=260.0), ["T_surf", "P_i_surf"]),
}
KERNEL_WRAPPERS = (rorr_cuda.k_rorr_mix_cuda, twostream_cuda.two_stream_ir_weighted_cuda,
                   twostream_cuda.two_stream_solar_multi_weighted_cuda)


@pytest.mark.parametrize("name", list(SOLVES))
def test_batched_solve_on_the_card_matches_the_cpu(solver_models, name):
    """Each batched solve on the card (graph-replayed march; the surface
    temperature solves through RORR, #1 and #2, each of which must launch)
    against the same call by the port on the CPU: results at rtol 1e-8,
    converged and status equal."""
    gpu, cpu, P_i = solver_models
    solve, keys = SOLVES[name]
    before = [w.launches for w in KERNEL_WRAPPERS]
    got = solve(gpu, cpu, P_i)
    launched = [w.launches - n for w, n in zip(KERNEL_WRAPPERS, before)]
    want = solve(cpu, cpu, P_i)
    assert got["converged"].device.type == "cuda" and bool(got["converged"].all())
    for k in keys:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(), rtol=1e-8, err_msg=k)
    for k in ("converged", "status"):
        assert torch.equal(got[k].cpu(), want[k]), k
    if name.startswith("surface_temperature"):
        assert min(launched) >= 1, launched


@pytest.fixture(scope="module")
def climate_models(tmp_path_factory):
    """The time-stepping Climate model at nz=12, 2 zenith angles
    (tests/test_climate.py's settings and atmosphere column), on the card and
    on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import yaml

    from clima_tpu_torch.climate import Climate
    from clima_tpu_torch.config import settings_from_dict
    from clima_tpu_torch.data import climate_settings_yaml_text, write_atmosphere_file

    atmosphere = str(tmp_path_factory.mktemp("climate") / "atmosphere.txt")
    write_atmosphere_file(atmosphere)
    tpl = make_template(nz=12, n_zenith=2)
    settings = settings_from_dict(yaml.safe_load(climate_settings_yaml_text(12, 2)))
    files = (tpl["species"], settings, tpl["star"], atmosphere, tpl["datadir"])
    gpu, cpu = Climate(*files), Climate(*files, device="cpu")
    assert gpu.device.type == "cuda"
    gpu.verbose = cpu.verbose = False
    return gpu, cpu


def _climate_states(c):
    """T_init, a perturbed state and a superadiabatic one (convection from
    the ground into the first layer and on into the second)."""
    convective = c.T_init.copy()
    convective[0] += 45.0
    convective[2] = convective[1] - 85.0
    return np.stack([c.T_init, c.T_init * (1.0 + 0.01 * np.sin(np.arange(c.neq))), convective])


def test_climate_rhs_on_the_card_matches_the_cpu(climate_models):
    """right_hand_side and the device RHS on the card (RORR, #1 and #2, each
    of which must launch, and no twin) against the port on the CPU: rtol
    1e-9, with chip_smoke.py's per-layer atol for the kernels' flux roundoff
    (1e-12 of the flux scale over rho cp dz)."""
    from chip_smoke import climate_tendency_atol, no_twins

    gpu, cpu = climate_models
    states = _climate_states(cpu)
    before = [w.launches for w in KERNEL_WRAPPERS]
    with no_twins():
        gpu._P = None
        got = np.stack([gpu.right_hand_side(y) for y in states])
        rhs, fluxes_fn = gpu._build_device_fns(T_freeze=states[1])
        got_dev = np.stack([rhs(gpu._t(y)).cpu().numpy() for y in states])
    assert min(w.launches - n for w, n in zip(KERNEL_WRAPPERS, before)) >= 1
    cpu._P = None
    want = np.stack([cpu.right_hand_side(y) for y in states])
    rhs_cpu, fluxes_cpu = cpu._build_device_fns(T_freeze=states[1])
    want_dev = np.stack([rhs_cpu(cpu._t(y)).numpy() for y in states])
    np.testing.assert_allclose(gpu._P, cpu._P, rtol=1e-14)
    y = cpu._t(states)
    fluxes = [a.numpy() for a in fluxes_cpu(y[:, 0], y[:, 1:])]
    atol = climate_tendency_atol(cpu, states, fluxes).numpy()
    for g, w in ((got, want), (got_dev, want_dev)):
        assert np.all(np.abs(g - w) <= atol + 1e-9 * np.abs(w)), np.abs(g - w) / atol


def test_climate_rk45_device_on_the_card_matches_the_cpu(climate_models, tmp_path):
    """A short rk45_device evolve on the card takes the CPU port's steps
    (T rtol 1e-8), and the snapshot batch's fluxes_fn agrees to 1e-9 of each
    array's largest value."""
    from clima_tpu_torch.climate import load_evolve_file

    gpu, cpu = climate_models
    t_eval = np.array([1.0e3, 1.0e4, 3.0e4])
    out = {}
    for name, c in (("gpu", gpu), ("cpu", cpu)):
        fn = str(tmp_path / f"{name}.npz")
        assert c.evolve(fn, 0.0, c.T_init, t_eval, overwrite=True, method="rk45_device")
        out[name] = load_evolve_file(fn), dict(c.evolve_stats)
    (got, st_gpu), (want, st_cpu) = out["gpu"], out["cpu"]
    assert st_gpu == st_cpu
    np.testing.assert_allclose(got["T"], want["T"], rtol=1e-8)
    for k in ("f_total", "fup_ir", "fdn_ir", "fup_sol", "fdn_sol"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9 * np.abs(want[k]).max(),
                                   err_msg=k)
    for k in ("P", "z", "t"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-14, err_msg=k)


def test_climate_rhs_outside_the_tables_is_nan_on_the_card(climate_models):
    """States outside heat_capacity's tables, and NaN states, give a NaN RHS
    through the kernels (what rk45_device rejects) without faulting the card;
    the RHS of a physical state afterwards is unchanged."""
    gpu, _ = climate_models
    rhs, _ = gpu._build_device_fns()
    y = gpu._t(gpu.T_init)
    want = rhs(y).cpu()
    above = torch.full_like(y, 7000.0)  # the template's tables end at 6000 K
    nan = torch.where(torch.arange(gpu.neq, device=y.device) == 3, float("nan"), y)
    for bad in (above, nan):
        assert not bool(torch.isfinite(rhs(bad)).all())
    torch.cuda.synchronize()
    assert torch.equal(rhs(y).cpu(), want)


def test_pallas_modes_on_the_card(dev):
    """On card tensors "never" makes each wrapper raise, pointing to its twin,
    without a launch, and "always" launches the kernel, as "auto" does; the
    modes are restored afterwards."""
    rng = np.random.default_rng(21)
    tau, w0, gt = _atm(16, 9, dev, 21)
    t = lambda x: torch.tensor(x, device=dev)
    emis, bpl, wbin = t(rng.uniform(0.8, 1.0, 16)), t(rng.uniform(0.01, 1.0, (16, 10))), \
        t(np.array([0.5, 0.5]))
    u0s, rs, zw = t(rng.uniform(0.2, 1.0, 3)), t(rng.uniform(0.0, 0.6, 16)), \
        t(rng.uniform(0.1, 0.5, 3))
    tau_ks = t(10 ** rng.uniform(-6, 1, (3, 8, 10)))
    wb = t(np.polynomial.legendre.leggauss(8)[1] / 2.0)
    wb_e = torch.cat([torch.zeros(1, dtype=wb.dtype, device=dev), torch.cumsum(wb, 0)])
    calls = [
        (twostream_cuda.two_stream_ir_weighted_cuda, twostream.two_stream_ir_weighted,
         (tau, w0, gt, emis, True, 1e-6, bpl, wbin)),
        (twostream_cuda.two_stream_solar_multi_weighted_cuda,
         twostream.two_stream_solar_multi_weighted, (tau, w0, gt, u0s, rs, zw, wbin)),
        (twostream_cuda.two_stream_ir_auto, twostream.two_stream_ir,
         (tau, w0, gt, emis, False, 1e-6, bpl)),
        (twostream_cuda.two_stream_solar_multi_auto, twostream.two_stream_solar_multi,
         (tau, w0, gt, u0s, rs)),
        (twostream_cuda.two_stream_solar_auto, twostream.two_stream_solar,
         (tau, w0, gt, u0s[:1].expand(16).contiguous(), rs)),
        (rorr_cuda.k_rorr_mix_cuda,
         lambda x, w, e: rorr.k_rorr_mix(x.movedim(1, -1).contiguous(), e).movedim(-1, 0),
         (tau_ks, wb, wb_e)),
    ]
    try:
        twostream.set_pallas_mode("never")
        opacity.set_rorr_pallas_mode("never")
        for wrapper, twin, args in calls:
            n = wrapper.launches
            with pytest.raises(ValueError, match="'never'.*call the twin"):
                wrapper(*args)
            assert wrapper.launches == n, wrapper.__name__
        twostream.set_pallas_mode("always")
        opacity.set_rorr_pallas_mode("always")
        for wrapper, twin, args in calls:
            n = wrapper.launches
            got, want = wrapper(*args), twin(*args)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            _close(got, want)
            assert wrapper.launches > n, wrapper.__name__
    finally:
        twostream.set_pallas_mode("auto")
        opacity.set_rorr_pallas_mode("auto")


def test_one_rank_mesh_on_the_card_is_bitwise(dev):
    """make_mesh() without a process group on the card (it starts none):
    batched_toa_fluxes and batched_surface_temperature equal mesh=None
    bitwise."""
    import torch.distributed as dist

    from clima_tpu_torch.parallel import make_mesh

    tpl = make_template(nz=8, n_zenith=2)
    c = AdiabatClimate(tpl["species"], tpl["settings"], tpl["star"], tpl["datadir"], substeps=2)
    P_i = np.full((2, c.sp.ng), 1.0e-15)
    P_i[:, c.species_names.index("H2O")] = 270.0e6
    P_i[:, c.species_names.index("CO2")] = [300.0, 600.0]
    P_i[:, c.species_names.index("N2")] = 1.0e6
    T_surf = np.array([280.0, 290.0])
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert mesh.size() == 1 and mesh.device_type == "cuda" and not dist.is_initialized()
    for got, want in ((batched_toa_fluxes(c, T_surf, P_i, mesh=mesh),
                       batched_toa_fluxes(c, T_surf, P_i)),
                      (batched_surface_temperature(c, P_i, mesh=mesh),
                       batched_surface_temperature(c, P_i))):
        for g, w in zip(got, want):
            assert torch.equal(g, w) if torch.is_tensor(w) else g == w


# --- the examples and the tools (-k "examples or tools") -------------------

EXAMPLE_NAMES = ("modern_earth_radtran", "tutorial_adiabat_climate", "early_mars",
                 "climate_evolve")


@pytest.mark.parametrize("name", EXAMPLE_NAMES)
def test_examples_on_the_card_match_the_cpu(dev, name, tmp_path):
    """Each example at nz=8 on the card against the same example on the CPU:
    TOA fluxes and f_total at rtol 1e-9, surface temperatures (the solves',
    early_mars's converged columns' and the snapshots') at rtol 1e-8, the
    same convergence."""
    import importlib

    mod = importlib.import_module(f"clima_tpu_torch.examples.{name}")
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    card = mod.main(nz=8, root=str(tmp_path / "card"))
    cpu = mod.main(device="cpu", nz=8, root=str(tmp_path / "cpu"))
    close = lambda k, rtol, **kw: np.testing.assert_allclose(card[k], cpu[k], rtol=rtol,
                                                             err_msg=k, **kw)
    if name == "modern_earth_radtran":
        for k in ("toa_solar_fdn", "olr"):
            close(k, 1e-9)
        close("f_total", 1e-9, atol=1e-6)
    elif name == "tutorial_adiabat_climate":
        close("ISR", 1e-9)
        close("OLR", 1e-9)
        close("T_surf_solve", 1e-8)
        assert card["converged"] and cpu["converged"]
        close("T_surf", 1e-8)
    elif name == "early_mars":  # unconverged columns hold their last iterate
        np.testing.assert_array_equal(card["converged"], cpu["converged"])
        conv = cpu["converged"]
        np.testing.assert_allclose(card["T_surf"][conv], cpu["T_surf"][conv], rtol=1e-8)
    else:
        assert card["converged"] and cpu["converged"]
        np.testing.assert_allclose(card["snapshots"]["T"][:, 0], cpu["snapshots"]["T"][:, 0],
                                   rtol=1e-8)


def test_tools_roofline_json_fields(dev, tmp_path):
    from clima_tpu_torch.tools import roofline

    out = tmp_path / "roofline.json"
    rows = roofline.main(["--columns", "4", "--nz", "42", "--iters", "2", "--out", str(out)])
    assert json.loads(out.read_text())["rows"] == json.loads(json.dumps(rows))
    assert len(rows) == 8
    for r in rows:
        assert {"kernel", "shape", "time_ms", "bytes", "ops", "achieved_GBs", "bound_ms",
                "bound_by", "share_of_bound"} <= set(r)
        assert r["time_ms"] > 0 and 0.0 < r["share_of_bound"] <= 1.0


def test_tools_validation_json_fields(dev, tmp_path):
    from clima_tpu_torch.tools import validation

    res = validation.main(["--nz", "6", "--out", str(tmp_path / "validation.json")])
    assert res["kernel_parity_ok"] and validation.parity_within(res["kernel_parity"])[0]
    assert {"solar_surfrad_maxrel", "solar_multi_surfrad_maxrel"} <= set(res["kernel_parity"])
    rec = res["device_rce"]
    assert rec["status"] == [0, 0] and res["cpu_f64"]["converged"]
    assert rec["vs_cpu_f64"]["mask_equal"] and rec["within_limits"]
    assert validation.rce_within(rec, res["cpu_f64"]["converged"])
    assert len(rec["ratio_trace"]) >= 1


def test_tools_rce_bench_json_fields(dev, tmp_path):
    from clima_tpu_torch.tools import rce_bench

    res = rce_bench.main(["--sizes", "2", "--nz", "6", "--out", str(tmp_path / "b.json")])
    run = res["runs"][0]
    assert run["status"] == [0, 0] and run["finite"]
    assert run["columns_per_s_without_capture"] >= run["columns_per_s_with_capture"] > 0
    assert min(run["second"]["launches"].values()) >= 1


def test_tools_scaling_json_fields(dev, tmp_path):
    from clima_tpu_torch.tools import scaling

    (rec,) = scaling.main(["--devices", "1", "--workloads", "toa", "--nz", "6", "--iters", "2",
                           "--out", str(tmp_path / "s.json")])
    assert rec["rank_exitcodes"] == [0] and rec["backend"] == "nccl"
    assert rec["wall_s_median"] > 0 and min(rec["launches"].values()) >= 1
    with pytest.raises(ValueError, match="more than"):
        scaling.main(["--devices", str(torch.cuda.device_count() + 1), "--workloads", "toa"])
