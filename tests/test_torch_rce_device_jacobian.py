"""The zone-block FD Jacobian and the mask limiter of the PyTorch port's
batched RCE (clima_tpu_torch.adiabat.rce_device) against clima_tpu's
(float64, CPU), on test_torch_rce_device.py's template and models (nz=8, 1
zenith angle, surface albedo 0.3, substeps 2; AdiabatClimate.from_reference).

- The Jacobian unchunked and at jac_chunk 1 and 7: against the JAX package's
  (its ``build_rce_fns`` objective and Jacobian jitted once for the module)
  at rtol 1e-8 with tests/test_rce_device.py's own FD floor (atol 2e-11, the
  residual's noise over delta), and against the port's unchunked Jacobian at
  rtol 1e-8, atol 1e-12.
- The mask limiter on random masks: the same masks.

(A file of its own, so that the test workers run it beside
test_torch_rce_device.py.)
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.adiabat import rce_device as ref_rce_device
from clima_tpu.data import make_template_dir

from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.adiabat import rce_device
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, SUBSTEPS = 8, 2
T_RAMP = np.linspace(285.0, 205.0, NZ + 1)

# tests/test_rce_device.py's masks, cut to nz=8
MASKS = {
    "none": np.zeros(NZ, bool),
    "ground_zone": np.arange(NZ) < 4,
    "mid_zone": (np.arange(NZ) >= 3) & (np.arange(NZ) < 6),
    "two_zones": (np.arange(NZ) < 2) | ((np.arange(NZ) >= 5) & (np.arange(NZ) < 7)),
}


def _files(t):
    return t["species"], t["settings"], t["star"], t["datadir"]


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    return make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=NZ, n_zenith=1,
                             surface_albedo=0.3)


@pytest.fixture(scope="module")
def models(template):
    ref = RefAdiabatClimate(*_files(template), substeps=SUBSTEPS)
    ref.verbose = False
    return ref, AdiabatClimate.from_reference(ref, *_files(template), device="cpu")


def _jitted(fns):
    return dict(fns, objective=jax.jit(fns["objective"]), jacobian=jax.jit(fns["jacobian"]))


@pytest.fixture(scope="module")
def ref_fns(models):
    return _jitted(ref_rce_device.build_rce_fns(models[0]))


def earth_like_P_i(c, co2_scale=1.0):
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0 * co2_scale
    P_i[c.species_names.index("N2")] = 1.0e6
    return P_i


def _batch(c, *arrays):
    """Host arrays of one column -> (1, ...) tensors on the port's model."""
    return tuple(torch.as_tensor(np.asarray(a)[None], device=c.device) for a in arrays)


def _port_objective(fns, c, T_in, mask, P_i):
    return fns["objective"](*_batch(c, T_in, mask, P_i))


@pytest.mark.parametrize("jac_chunk", [None, 1, 7])
def test_jacobian_matches_reference(models, ref_fns, jac_chunk):
    ref, c = models
    P_i, mask = earth_like_P_i(c), MASKS["two_zones"]
    want_obj = ref_fns["objective"](jnp.asarray(T_RAMP), jnp.asarray(mask), jnp.asarray(P_i))
    want = np.asarray(ref_fns["jacobian"](want_obj[0], jnp.asarray(mask), want_obj[3],
                                          want_obj[2]))
    fns = rce_device.build_rce_fns(c, jac_chunk=jac_chunk)
    xm, _, dTdt, aux = _port_objective(fns, c, T_RAMP, mask, P_i)
    conv = torch.as_tensor(mask[None])
    got = fns["jacobian"](xm, conv, aux, dTdt)[0].numpy()
    # the FD quotients carry the residuals' 1e-11-of-the-flux-scale
    # difference over delta: tests/test_rce_device.py's FD floor
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=2e-11)
    if jac_chunk is not None:
        full = rce_device.build_rce_fns(c)["jacobian"](xm, conv, aux, dTdt)[0].numpy()
        np.testing.assert_allclose(got, full, rtol=1e-8, atol=1e-12)
    # slaved columns are identity
    slaved = np.flatnonzero(np.concatenate([[False], mask]))
    np.testing.assert_array_equal(got[:, slaved], np.eye(NZ + 1)[:, slaved])


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_mask_limiter_matches_reference(models, ref_fns, shift):
    """Random masks (25 lanes at once on the port's side) through the limiter."""
    ref, c = models
    rng = np.random.default_rng(42 + shift)
    n = 25
    save = rng.random((n, NZ)) < 0.35
    candidate = rng.random((n, NZ)) < 0.5
    difference = rng.normal(0.0, 0.05, (n, NZ))
    lri = rng.normal(0.2, 0.05, (n, NZ))
    saved = ref.convective_max_boundary_shift, c.convective_max_boundary_shift
    ref.convective_max_boundary_shift = c.convective_max_boundary_shift = shift
    try:
        fns = rce_device.build_rce_fns(c)
        ref_limiter = ref_rce_device.build_rce_fns(ref)["apply_mask_limiter"]
    finally:
        ref.convective_max_boundary_shift, c.convective_max_boundary_shift = saved
    for no_c2r in (False, True):
        got = fns["apply_mask_limiter"](*(torch.as_tensor(a) for a in (save, candidate)),
                                        torch.as_tensor(difference), no_c2r,
                                        torch.as_tensor(lri)).numpy()
        for i in range(n):
            want = np.asarray(ref_limiter(jnp.asarray(save[i]), jnp.asarray(candidate[i]),
                                          jnp.asarray(difference[i]), no_c2r,
                                          jnp.asarray(lri[i])))
            np.testing.assert_array_equal(got[i], want, err_msg=f"lane {i} no_c2r={no_c2r}")


