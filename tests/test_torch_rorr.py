"""RORR k-mixing of the PyTorch port against clima_tpu (CPU): the sort-path
twin and the plain model of the CUDA kernel's schedule
(``mix_pair_sorted_ref``) against the reference's XLA path, its rank form and
its Pallas kernel in interpret mode (float64, rtol 1e-9), and the tie
handling of both plain forms, including the float32 near-tie chain."""

import functools
import warnings
from unittest import mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax.experimental.pallas as pl

from clima_tpu.ops import rorr as ref_rorr
from clima_tpu.ops.pallas_rorr import k_rorr_mix_pallas, mix_pair_rank_ref as ref_rank

from clima_tpu_torch.ops import rorr, rorr_cuda
from clima_tpu_torch.radtran import opacity
from clima_tpu_torch.radtran.opacity import _rorr_mix


@pytest.fixture()
def interpret():
    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)):
        yield


def _weights(rng, nbin):
    w = rng.uniform(0.5, 1.5, nbin)
    wbin = w / w.sum()
    return wbin, np.concatenate([[0.0], np.cumsum(wbin)])


@pytest.mark.parametrize("nbin", [8, 16])
def test_k_rorr_mix_matches_reference(interpret, nbin):
    rng = np.random.default_rng(5)
    tau_ks = 10 ** rng.uniform(-6, 1, (3, 7, 11, nbin))
    wbin, wbin_e = _weights(rng, nbin)
    xla = np.asarray(ref_rorr.k_rorr_mix(jnp.asarray(tau_ks), jnp.asarray(wbin_e)))
    kern = np.asarray(k_rorr_mix_pallas(jnp.asarray(tau_ks), wbin, wbin_e, block_l=128))
    got = rorr.k_rorr_mix(torch.tensor(tau_ks), torch.tensor(wbin_e)).numpy()
    np.testing.assert_allclose(got, xla, rtol=1e-9)
    np.testing.assert_allclose(got, kern, rtol=1e-9)
    # the kernel wrapper's layout (nk, nbin, R) on the CPU runs the same twin
    # (on a differently strided batch, so sums may round differently)
    t = torch.tensor(tau_ks).reshape(3, -1, nbin).movedim(-1, 1).contiguous()
    wrapped = rorr_cuda.k_rorr_mix_cuda(t, torch.tensor(wbin), torch.tensor(wbin_e))
    np.testing.assert_allclose(wrapped.T.reshape(got.shape).numpy(), got, rtol=1e-14)
    # and the rank form agrees with both
    rows = torch.tensor(tau_ks).reshape(3, -1, nbin)
    wxy = rorr.make_wxy(torch.tensor(wbin))
    mixed = rows[0]
    for k in (1, 2):
        mixed = rorr_cuda.mix_pair_rank_ref(mixed, rows[k], wxy, torch.tensor(wbin_e))
    np.testing.assert_allclose(mixed.reshape(got.shape).numpy(), xla, rtol=1e-9)


def test_rank_ref_matches_reference():
    rng = np.random.default_rng(3)
    a = np.sort(10 ** rng.uniform(-6, 1, (40, 8)), axis=-1)
    b = np.sort(10 ** rng.uniform(-6, 1, (40, 8)), axis=-1)
    wbin, wbin_e = _weights(rng, 8)
    wxy = np.outer(wbin, wbin).reshape(-1)
    want = np.asarray(ref_rank(jnp.asarray(a), jnp.asarray(b), wxy, wbin_e))
    got = rorr_cuda.mix_pair_rank_ref(*(torch.tensor(x) for x in (a, b, wxy, wbin_e)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)


def test_rank_ref_tie_handling():
    """Equal keys must get distinct rank windows (no weight duplication)."""
    a = torch.full((16, 8), 0.25, dtype=torch.float64)
    b = torch.full((16, 8), 0.5, dtype=torch.float64)  # all 64 pair sums identical
    w = torch.full((8,), 0.125, dtype=torch.float64)
    wbin_e = torch.cat([torch.zeros(1, dtype=torch.float64), torch.cumsum(w, 0)])
    got = rorr_cuda.mix_pair_rank_ref(a, b, rorr.make_wxy(w), wbin_e)
    np.testing.assert_allclose(got.numpy(), 0.75, rtol=1e-12)


def test_rank_mix_near_tie_collision_f32():
    """float32 three-species chain: stage-2 keys are sums of rebinned values
    that cluster within a few ulps. The exact tie-break keeps the rank form
    within 1e-4 of the sort path; folding the index into the keys instead
    (not injective) measured 0.087 at the JAX package's shapes."""
    rng = np.random.default_rng(1)
    nk, R, nbin = 3, 16 * 101, 8
    wbin = np.polynomial.legendre.leggauss(nbin)[1] / 2.0
    wbin_e = np.concatenate([[0.0], np.cumsum(wbin)])
    wbin_e[-1] = 1.0
    tau_ks = torch.tensor(10.0 ** rng.uniform(-6, 2, (nk, R, nbin)), dtype=torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    sort_path = rorr.k_rorr_mix(tau_ks, f32(wbin_e)).double()
    mixed = tau_ks[0]
    for k in range(1, nk):
        mixed = rorr_cuda.mix_pair_rank_ref(mixed, tau_ks[k], rorr.make_wxy(f32(wbin)),
                                            f32(wbin_e))
    maxrel = float((mixed.double() - sort_path).abs().max() / sort_path.abs().max())
    assert maxrel < 1e-4, f"rank chain deviates from sort path: {maxrel:.3e}"


def _sorted_chain(rows, wbin, wbin_e):
    wxy = rorr.make_wxy(wbin)
    mixed = rows[0]
    for k in range(1, rows.shape[0]):
        mixed = rorr_cuda.mix_pair_sorted_ref(mixed, rows[k], wxy, wbin_e)
    return mixed


@pytest.mark.parametrize("nbin", [1, 3, 8, 12, 16])
def test_sorted_ref_matches_reference(interpret, nbin):
    """The kernel's schedule (padded to 16, 64 or 256 pairs for nbin 1, 3 and
    12) against the JAX package: one pair mix against its rank form, the
    three-species chain against its XLA sort path and its Pallas kernel."""
    rng = np.random.default_rng(10 + nbin)
    tau_ks = 10 ** rng.uniform(-6, 1, (3, 37, nbin))
    wbin, wbin_e = _weights(rng, nbin)
    wxy = np.outer(wbin, wbin).reshape(-1)
    pair = rorr_cuda.mix_pair_sorted_ref(*(torch.tensor(x) for x in (tau_ks[0], tau_ks[1], wxy,
                                                                       wbin_e)))
    want = np.asarray(ref_rank(jnp.asarray(tau_ks[0]), jnp.asarray(tau_ks[1]), wxy, wbin_e))
    np.testing.assert_allclose(pair.numpy(), want, rtol=1e-9)
    got = _sorted_chain(torch.tensor(tau_ks), torch.tensor(wbin), torch.tensor(wbin_e)).numpy()
    xla = np.asarray(ref_rorr.k_rorr_mix(jnp.asarray(tau_ks), jnp.asarray(wbin_e)))
    kern = np.asarray(k_rorr_mix_pallas(jnp.asarray(tau_ks), wbin, wbin_e, block_l=128))
    np.testing.assert_allclose(got, xla, rtol=1e-9)
    np.testing.assert_allclose(got, kern, rtol=1e-9)


@pytest.mark.parametrize("nbin", [3, 8, 16])
def test_sorted_ref_tie_handling(nbin):
    """All nbin^2 keys equal: the sort still gives each pair its own window
    (pads included), so the mix is the key everywhere."""
    a = torch.full((16, nbin), 0.25, dtype=torch.float64)
    b = torch.full((16, nbin), 0.5, dtype=torch.float64)
    w = torch.full((nbin,), 1.0 / nbin, dtype=torch.float64)
    wbin_e = torch.cat([torch.zeros(1, dtype=torch.float64), torch.cumsum(w, 0)])
    got = rorr_cuda.mix_pair_sorted_ref(a, b, rorr.make_wxy(w), wbin_e)
    np.testing.assert_allclose(got.numpy(), 0.75, rtol=1e-12)
    ref = np.asarray(ref_rank(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                              rorr.make_wxy(w).numpy(), wbin_e.numpy()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


def test_sorted_mix_near_tie_collision_f32():
    """The float32 near-tie chain of test_rank_mix_near_tie_collision_f32
    through the kernel's schedule: the composite (bits, index) order keeps
    it within 1e-4 of the sort path."""
    rng = np.random.default_rng(1)
    nk, R, nbin = 3, 16 * 101, 8
    wbin = np.polynomial.legendre.leggauss(nbin)[1] / 2.0
    wbin_e = np.concatenate([[0.0], np.cumsum(wbin)])
    wbin_e[-1] = 1.0
    tau_ks = torch.tensor(10.0 ** rng.uniform(-6, 2, (nk, R, nbin)), dtype=torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    sort_path = rorr.k_rorr_mix(tau_ks, f32(wbin_e)).double()
    mixed = _sorted_chain(tau_ks, f32(wbin), f32(wbin_e))
    assert mixed.dtype == torch.float32
    maxrel = float((mixed.double() - sort_path).abs().max() / sort_path.abs().max())
    assert maxrel < 1e-4, f"sorted chain deviates from sort path: {maxrel:.3e}"


def test_k_aee_mix_and_pair_weights_match_reference():
    rng = np.random.default_rng(4)
    tau_ks = 10 ** rng.uniform(-6, 1, (3, 5, 9, 8))
    wbin = rng.uniform(0.5, 1.5, 8)
    wbin /= wbin.sum()
    np.testing.assert_allclose(
        rorr.k_aee_mix(torch.tensor(tau_ks), torch.tensor(wbin)).numpy(),
        np.asarray(ref_rorr.k_aee_mix(jnp.asarray(tau_ks), jnp.asarray(wbin))), rtol=1e-13)
    np.testing.assert_array_equal(rorr.make_wxy(torch.tensor(wbin)).numpy(),
                                  np.asarray(ref_rorr.make_wxy(jnp.asarray(wbin))))


def test_wrapper_never_hands_accelerator_tensors_to_the_twin():
    meta = torch.empty((3, 8, 10), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        rorr_cuda.k_rorr_mix_cuda(meta, torch.ones(8), torch.linspace(0, 1, 9))
    assert rorr_cuda.k_rorr_mix_cuda.launches == 0


def test_opacity_rorr_routing_past_nbin_16():
    """compute_opacity's RORR step: past nbin=16 the sort path runs with a
    warning and matches the reference's XLA path, on the tensors' own device
    (the meta device here stands in for the card); one species passes through
    unmixed."""
    rng = np.random.default_rng(6)
    nbin = 20
    tau_ks = 10 ** rng.uniform(-6, 1, (3, nbin, 13))
    wbin, wbin_e = _weights(rng, nbin)
    with pytest.warns(UserWarning, match="nbin=20 > 16"):
        got = _rorr_mix(torch.tensor(tau_ks), torch.tensor(wbin), torch.tensor(wbin_e))
    want = ref_rorr.k_rorr_mix(jnp.asarray(np.moveaxis(tau_ks, 1, -1)), jnp.asarray(wbin_e))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 0), rtol=1e-12)
    meta = torch.empty((3, nbin, 13), dtype=torch.float64, device="meta")
    with pytest.warns(UserWarning, match="nbin=20 > 16"):
        out = _rorr_mix(meta, torch.tensor(wbin, device="meta"),
                        torch.tensor(wbin_e, device="meta"))
    assert out.device.type == "meta" and out.shape == (nbin, 13)
    one = torch.tensor(tau_ks[:1])
    assert torch.equal(_rorr_mix(one, torch.tensor(wbin), torch.tensor(wbin_e)), one[0])


def test_sort_path_runs_in_lane_chunks():
    """Past nbin 16 the sort path runs over chunks of lanes (here 8 lanes
    each, the bound patched small), with the warning: the result is bitwise
    the unchunked sort path's on the same lane-major layout."""
    rng = np.random.default_rng(8)
    nbin, R = 20, 37
    tau_ks = torch.tensor(10 ** rng.uniform(-6, 1, (3, nbin, R)))
    wbin, wbin_e = (torch.tensor(x) for x in _weights(rng, nbin))
    with mock.patch.object(opacity, "_SORT_CHUNK_KEYS", 8 * nbin * nbin), \
            mock.patch.object(opacity, "k_rorr_mix", wraps=rorr.k_rorr_mix) as sort_path:
        with pytest.warns(UserWarning, match="nbin=20 > 16"):
            got = _rorr_mix(tau_ks, wbin, wbin_e)
    assert sort_path.call_count == 5
    want = rorr.k_rorr_mix(tau_ks.movedim(1, -1).contiguous(), wbin_e).movedim(-1, 0)
    assert got.shape == (nbin, R) and torch.equal(got, want)


def test_rorr_past_nbin_16_takes_the_sort_path():
    """nbin alone routes: at nbin=20 the kernel's wrapper is never called
    and the sort path gives the JAX package's XLA result; at nbin=16 the
    wrapper is called."""
    rng = np.random.default_rng(7)
    wrapper = mock.Mock(side_effect=rorr_cuda.k_rorr_mix_cuda)
    with mock.patch.object(opacity, "k_rorr_mix_cuda", wrapper), \
            mock.patch.object(opacity, "k_rorr_mix", wraps=rorr.k_rorr_mix) as sort_path:
        for nbin in (20, 16):
            tau_ks = 10 ** rng.uniform(-6, 1, (2, nbin, 9))
            wbin, wbin_e = _weights(rng, nbin)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = opacity._rorr_mix(torch.tensor(tau_ks), torch.tensor(wbin),
                                        torch.tensor(wbin_e))
            want = ref_rorr.k_rorr_mix(jnp.asarray(np.moveaxis(tau_ks, 1, -1)),
                                       jnp.asarray(wbin_e))
            np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 0),
                                       rtol=1e-12)
            if nbin == 20:
                assert sort_path.call_count == 1 and wrapper.call_count == 0
    assert wrapper.call_count == 1
