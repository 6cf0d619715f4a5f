"""The port's counterparts of the JAX package's remaining public names
(float64, CPU), each against its JAX twin on seeded inputs:

- ``ops.interp.interp1d``/``interp2d`` (gathers with linear extrapolation;
  same formula, rtol 1e-13);
- ``ops.tridiag.tridiag_batched_last``, ``tridiag_pcr``,
  ``tridiag_block2_pcr`` and ``block2_pcr_components_dense`` at the limits
  of ``tests/test_tridiag_twostream.py`` (dense against structured block PCR
  1e-12/1e-14, against Thomas 1e-9, Thomas 1e-11);
- ``ops.rebin.rebin_jnp`` and ``grid_at_exact`` at ``tests/test_rebin.py``'s
  (1e-12 against numpy's rebin, 1e-11 batched);
- ``ops.twostream.set_tridiag_method``: "thomas" against the JAX package's
  "thomas" (rtol 1e-12) and against "pcr" (rtol 1e-9, the kernels' bound);
- the kernel switches ``ops.twostream.set_pallas_mode`` and
  ``radtran.opacity.set_rorr_pallas_mode``: "always" raises on CPU tensors,
  "never" runs the twins on CPU tensors only, "auto" is the default; each
  test leaves the modes as it found them;
- ``radtran.RTChannelView`` on the port's channels.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from clima_tpu.ops import interp as ref_interp
from clima_tpu.ops import rebin as ref_rebin
from clima_tpu.ops import tridiag as ref_tridiag
from clima_tpu.ops import twostream as ref_ts
from clima_tpu.radtran import RTChannelView as RefRTChannelView

from clima_tpu_torch.ops import interp, rebin, rorr_cuda, tridiag
from clima_tpu_torch.ops import twostream as ts
from clima_tpu_torch.ops import twostream_cuda as tc
from clima_tpu_torch.radtran import RTChannelView
from clima_tpu_torch.radtran import opacity
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


T = lambda *xs: [torch.tensor(x) for x in xs]
J = lambda *xs: [jnp.asarray(x) for x in xs]
# the JAX twins jitted where that is cheaper (one compile a shape, where
# eager mode compiles every primitive)
ref_interp1d, ref_interp2d = jax.jit(ref_interp.interp1d), jax.jit(ref_interp.interp2d)
ref_tridiag_batched_last = jax.jit(ref_tridiag.tridiag_batched_last)
ref_tridiag_pcr = jax.jit(ref_tridiag.tridiag_pcr)
ref_tridiag_block2_pcr = ref_tridiag.tridiag_block2_pcr  # eager: cheaper at six sizes
ref_block2_pcr_components_dense = ref_tridiag.block2_pcr_components_dense
ref_rebin_jnp = jax.jit(ref_rebin.rebin_jnp)


def test_interp1d_matches_reference():
    rng = np.random.default_rng(0)
    xs = np.sort(rng.uniform(0.0, 10.0, 12))
    ys = rng.uniform(-1.0, 1.0, 12)
    x = np.concatenate([rng.uniform(-2.0, 12.0, 30), xs[[0, 5, -1]]])  # past both edges too
    np.testing.assert_allclose(interp.interp1d(*T(x, xs, ys)).numpy(),
                               np.asarray(ref_interp1d(*J(x, xs, ys))), rtol=1e-13)
    table = rng.uniform(-1.0, 1.0, (5, 12))  # per-bin tables, one x each
    xb = rng.uniform(-1.0, 11.0, 5)
    np.testing.assert_allclose(interp.interp1d(*T(xb, xs, table)).numpy(),
                               np.asarray(ref_interp1d(*J(xb, xs, table))), rtol=1e-13)
    np.testing.assert_allclose(interp.interp1d(3.3, *T(xs, table)).numpy(),
                               np.asarray(ref_interp1d(3.3, *J(xs, table))), rtol=1e-13)


def test_interp2d_matches_reference():
    rng = np.random.default_rng(1)
    xs, ys = np.sort(rng.uniform(0.0, 5.0, 7)), np.sort(rng.uniform(100.0, 400.0, 9))
    table = rng.uniform(-3.0, 3.0, (7, 9))
    x, y = rng.uniform(-1.0, 6.0, 25), rng.uniform(50.0, 450.0, 25)
    np.testing.assert_allclose(interp.interp2d(*T(x, y, xs, ys, table)).numpy(),
                               np.asarray(ref_interp2d(*J(x, y, xs, ys, table))),
                               rtol=1e-13)
    batched = rng.uniform(-3.0, 3.0, (4, 7, 9))  # (gauss, P, T) tables
    np.testing.assert_allclose(interp.interp2d(2.2, 250.0, *T(xs, ys, batched)).numpy(),
                               np.asarray(ref_interp2d(2.2, 250.0,
                                                              *J(xs, ys, batched))),
                               rtol=1e-13)
    xg, yg = rng.uniform(0.0, 5.0, 4), rng.uniform(100.0, 400.0, 4)  # one point per table
    np.testing.assert_allclose(interp.interp2d(*T(xg, yg, xs, ys, batched)).numpy(),
                               np.asarray(ref_interp2d(*J(xg, yg, xs, ys, batched))),
                               rtol=1e-13)


def _bands(rng, shape, dominant=True):
    a = rng.uniform(0.1, 1.0, shape)
    b = rng.uniform(3.0, 5.0, shape)
    if not dominant:
        b = b * np.where(rng.uniform(size=shape) < 0.5, -1.0, 1.0)
    return a, b, rng.uniform(0.1, 1.0, shape), rng.uniform(-1.0, 1.0, shape)


def test_tridiag_batched_last_matches_reference():
    a, b, c, d = _bands(np.random.default_rng(1), (7, 20))
    got = tridiag.tridiag_batched_last(*T(a, b, c, d)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_tridiag_batched_last(
        *J(a, b, c, d))), rtol=1e-11)
    for i in range(7):
        M = np.diag(b[i]) + np.diag(a[i, 1:], -1) + np.diag(c[i, :-1], 1)
        np.testing.assert_allclose(got[i], np.linalg.solve(M, d[i]), rtol=1e-10)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_tridiag_pcr_matches_reference(n):
    a, b, c, d = _bands(np.random.default_rng(10 + n), (3, n))
    got = tridiag.tridiag_pcr(*T(a, b, c, d)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_tridiag_pcr(*J(a, b, c, d))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got, tridiag.tridiag_batched_last(*T(a, b, c, d)).numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("m", [1, 2, 3, 7, 8, 101])
def test_block2_pcr_dense_and_block_tridiag_match_reference(m):
    """The dense block PCR against the JAX package's and against the port's
    structured form; tridiag_block2_pcr on the interleaved system against the
    JAX package's and against Thomas (block pivots of either sign)."""
    rng = np.random.default_rng(42 + m)
    a, b, c, d = _bands(rng, (2 * m,), dominant=False)
    a[0], c[-1] = 0.0, 0.0
    comps = (a[0::2], b[0::2], c[0::2], a[1::2], b[1::2], c[1::2], d[0::2], d[1::2])
    dense = tridiag.block2_pcr_components_dense(*T(*comps))
    for g, w, s in zip(dense, ref_block2_pcr_components_dense(*J(*comps)),
                       tridiag.block2_pcr_components(*T(*comps))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=1e-12, atol=1e-14)
    got = tridiag.tridiag_block2_pcr(*T(a, b, c, d)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_tridiag_block2_pcr(*J(a, b, c, d))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got, tridiag.tridiag_batched_last(*T(a, b, c, d)).numpy(),
                               rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="even"):
        tridiag.tridiag_block2_pcr(*T(a[:-1], b[:-1], c[:-1], d[:-1]))


def test_rebin_jnp_matches_reference():
    rng = np.random.default_rng(3)
    old = np.sort(rng.uniform(0, 1, 26))
    old[0], old[-1] = 0.0, 1.0
    vals = rng.uniform(0, 10, 25)
    new = np.linspace(0, 1, 6)
    got = rebin.rebin_jnp(*T(old, vals, new)).numpy()
    np.testing.assert_allclose(got, rebin.rebin(old, vals, new), rtol=1e-12)
    np.testing.assert_allclose(got, np.asarray(ref_rebin_jnp(*J(old, vals, new))),
                               rtol=1e-12)
    # a new grid reaching past the old one: regions outside contribute zero
    wide = np.linspace(-0.5, 1.5, 9)
    np.testing.assert_allclose(rebin.rebin_jnp(*T(old, vals, wide)).numpy(),
                               np.asarray(ref_rebin_jnp(*J(old, vals, wide))),
                               rtol=1e-12)


def test_rebin_jnp_batched_matches_reference():
    rng = np.random.default_rng(4)
    B, n_old, n_new = 5, 16, 4
    widths = rng.uniform(0.1, 1.0, (B, n_old))
    widths /= widths.sum(axis=1, keepdims=True)
    old = np.concatenate([np.zeros((B, 1)), np.cumsum(widths, axis=1)], axis=1)
    old[:, -1] = 1.0
    vals = rng.uniform(0, 10, (B, n_old))
    new = np.linspace(0, 1, n_new + 1)
    got = rebin.rebin_jnp(*T(old, vals, new)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_rebin_jnp(*J(old, vals, new))),
                               rtol=1e-11)
    for i in range(B):
        np.testing.assert_allclose(got[i], rebin.rebin(old[i], vals[i], new), rtol=1e-11)


def test_grid_at_exact_matches_reference():
    for n, lo, hi in ((5, 0.1, 0.7), (101, 1.0e-3, 3.3), (2, -1.0, 1.0)):
        g = rebin.grid_at_exact(n, lo, hi)
        np.testing.assert_array_equal(g, ref_rebin.grid_at_exact(n, lo, hi))
        assert (g[0], g[-1]) == (lo, hi)


@pytest.fixture()
def modes():
    """Restores the tridiagonal method and both kernel switches."""
    yield
    ts.set_tridiag_method("pcr")
    ref_ts.set_tridiag_method("pcr")
    ts.set_pallas_mode("auto")
    opacity.set_rorr_pallas_mode("auto")


def _ir_inputs(rng, rows, nz):
    tau = rng.uniform(1e-6, 2.0, (rows, nz))
    tau[1, 3] = 1e-7  # the thin-layer branch
    return (tau, rng.uniform(0.02, 0.999, (rows, nz)), rng.uniform(0.0, 0.85, (rows, nz)),
            rng.uniform(0.8, 1.0, rows), rng.uniform(1e-2, 1.0, (rows, nz + 1)))


@pytest.mark.parametrize("hard", [True, False])
def test_thomas_method_matches_reference_and_pcr(modes, hard):
    rng = np.random.default_rng(11)
    tau, w0, gt, emis, bpl = _ir_inputs(rng, 6, 13)
    u0, rs = rng.uniform(0.2, 1.0, 6), rng.uniform(0.0, 0.6, 6)
    u0s, zw = rng.uniform(0.2, 1.0, 3), rng.uniform(0.1, 0.5, 3)
    wbin = np.polynomial.legendre.leggauss(2)[1] / 2.0

    def calls(mod, A):
        return dict(
            ir=mod.two_stream_ir(*A(tau, w0, gt, emis), hard, 1e-6, *A(bpl)),
            solar=mod.two_stream_solar(*A(tau, w0, gt, u0, rs)),
            multi=mod.two_stream_solar_multi(*A(tau, w0, gt, u0s, rs)),
            ir_w=mod.two_stream_ir_weighted(*A(tau, w0, gt, emis), hard, 1e-6, *A(bpl, wbin)),
            solar_w=mod.two_stream_solar_multi_weighted(*A(tau, w0, gt, u0s, rs, zw, wbin)))

    pcr = calls(ts, T)
    ts.set_tridiag_method("thomas")
    ref_ts.set_tridiag_method("thomas")
    thomas = calls(ts, T)
    # the JAX package's Thomas solves, traced now (new functions, so no trace
    # of its default method is reused)
    ref_thomas = dict(
        ir=jax.jit(lambda *a: ref_ts.two_stream_ir(*a[:4], hard, 1e-6, a[4]))(
            *J(tau, w0, gt, emis, bpl)),
        solar=jax.jit(lambda *a: ref_ts.two_stream_solar(*a))(*J(tau, w0, gt, u0, rs)))
    for k in pcr:
        for g, w in zip(thomas[k], pcr[k]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12,
                                       err_msg=k)
    for k, want in ref_thomas.items():
        for g, w in zip(thomas[k], want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-15,
                                       err_msg=k)
    with pytest.raises(ValueError):
        ts.set_tridiag_method("lu")


def _wrapper_calls(A):
    """Each two-stream wrapper on CPU inputs from A (T: tensors)."""
    rng = np.random.default_rng(12)
    tau, w0, gt, emis, bpl = _ir_inputs(rng, 8, 5)
    u0s, rs, zw = rng.uniform(0.2, 1.0, 2), rng.uniform(0.0, 0.6, 8), rng.uniform(0.1, 0.5, 2)
    u0, wbin = rng.uniform(0.2, 1.0, 8), np.array([0.5, 0.5])
    return {
        "two_stream_ir_weighted_cuda": lambda: tc.two_stream_ir_weighted_cuda(
            *A(tau, w0, gt, emis), True, 1e-6, *A(bpl, wbin)),
        "two_stream_solar_multi_weighted_cuda": lambda: tc.two_stream_solar_multi_weighted_cuda(
            *A(tau, w0, gt, u0s, rs, zw, wbin)),
        "two_stream_ir_auto": lambda: tc.two_stream_ir_auto(*A(tau, w0, gt, emis), True, 1e-6,
                                                            *A(bpl)),
        "two_stream_solar_multi_auto": lambda: tc.two_stream_solar_multi_auto(
            *A(tau, w0, gt, u0s, rs)),
        "two_stream_solar_auto": lambda: tc.two_stream_solar_auto(*A(tau, w0, gt, u0, rs)),
    }


def test_pallas_mode_switches_the_wrappers(modes):
    """"auto" and "never" run the twins for CPU tensors (the same values),
    "always" refuses CPU tensors, and every mode refuses a tensor on another
    device (meta here); no mode launches a kernel. (On the card "never"
    refuses: ``test_torch_cuda.py``.)"""
    auto = {k: fn() for k, fn in _wrapper_calls(T).items()}
    meta = lambda *xs: [torch.empty(np.shape(x), dtype=torch.float64, device="meta")
                        for x in xs]
    ts.set_pallas_mode("never")
    for k, fn in _wrapper_calls(T).items():
        for g, w in zip(fn(), auto[k]):
            assert (g is None and w is None) or torch.equal(g, w), k
    for mode in ("auto", "never", "always"):
        ts.set_pallas_mode(mode)
        for k, fn in _wrapper_calls(meta).items():
            with pytest.raises(ValueError, match=f"device meta under set_pallas_mode\\('{mode}'\\)"):
                fn()
    ts.set_pallas_mode("always")
    for k, fn in _wrapper_calls(T).items():
        with pytest.raises(ValueError, match="'always'"):
            fn()
    assert [getattr(tc, k).launches for k in auto] == [0] * len(auto)
    with pytest.raises(ValueError):
        ts.set_pallas_mode("sometimes")


def test_rorr_pallas_mode_switches_the_wrapper(modes):
    rng = np.random.default_rng(13)
    nbin = 8
    tau_ks = torch.tensor(10 ** rng.uniform(-6, 1, (3, nbin, 10)))
    wbin = torch.tensor(np.polynomial.legendre.leggauss(nbin)[1] / 2.0)
    wbin_e = torch.cat([torch.zeros(1), torch.cumsum(wbin, 0)]).double()
    auto = rorr_cuda.k_rorr_mix_cuda(tau_ks, wbin, wbin_e)
    opacity.set_rorr_pallas_mode("never")
    assert torch.equal(rorr_cuda.k_rorr_mix_cuda(tau_ks, wbin, wbin_e), auto)
    meta = torch.empty(tau_ks.shape, dtype=torch.float64, device="meta")
    for mode in ("auto", "never", "always"):
        opacity.set_rorr_pallas_mode(mode)
        with pytest.raises(ValueError, match=f"device meta under set_rorr_pallas_mode\\('{mode}'\\)"):
            rorr_cuda.k_rorr_mix_cuda(meta, wbin.to("meta"), wbin_e.to("meta"))
    opacity.set_rorr_pallas_mode("always")
    with pytest.raises(ValueError, match="'always'"):
        rorr_cuda.k_rorr_mix_cuda(tau_ks, wbin, wbin_e)
    assert rorr_cuda.k_rorr_mix_cuda.launches == 0
    with pytest.raises(ValueError):
        opacity.set_rorr_pallas_mode("sometimes")


def test_rt_channel_view_matches_reference():
    """RTChannelView over the port's IR and solar channels: the JAX package's
    view of the same channel gives the same arrays and bin count."""
    from clima_tpu_torch.data import make_template
    from clima_tpu_torch.radtran import Radtran

    tpl = make_template(nz=4, n_zenith=1)
    rad = Radtran(["H2O", "CO2", "N2"], [], tpl["settings"], tpl["star"], 1, 0.25, 4,
                  tpl["datadir"], device="cpu")
    for info in (rad.ir, rad.sol):
        got, want = RTChannelView(info), RefRTChannelView(info)
        assert got.nw == want.nw == info.nw and got.wavl.shape == (info.nw + 1,)
        np.testing.assert_array_equal(got.wavl, want.wavl)
        np.testing.assert_array_equal(got.freq, want.freq)
        assert isinstance(got.wavl, np.ndarray) and isinstance(got.freq, np.ndarray)
