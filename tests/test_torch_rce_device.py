"""Batched RCE of the PyTorch port (clima_tpu_torch.adiabat.rce_device) against
clima_tpu's (float64, CPU): the objective, its lanes, and the tidally locked
objective and Jacobian.

One synthetic template (nz=8, 1 zenith angle, surface albedo 0.3, substeps
2); the port's model gets the JAX model's opacity tables and free parameters
(AdiabatClimate.from_reference). The JAX side is the JAX package's
``build_rce_fns``, its objective and Jacobian jitted once per model.

- The objective on the four masks of tests/test_rce_device.py (cut to nz=8),
  at T = linspace(285, 205): rtol 1e-9, with an atol of 1e-10 of the flux
  scale (dTdt: that over the smallest heat capacity's ratio). At these
  states the two packages' net fluxes differ by up to 1.4e-11 of the flux
  scale (the host objectives of both packages too: ulp differences of exp
  in the two-stream terms, summed over the bins); where the residuals cancel
  to a small value they keep that absolute error.
- The four masks as one batch equal four single evaluations.
- The tidally locked objective and Jacobian (compute_solar_in_jac on): the
  Jacobian at rtol 1e-8 with tests/test_rce_device.py's FD floor (atol
  2e-11).

The zone-block Jacobian and the mask limiter are in
test_torch_rce_device_jacobian.py, the three mask-update modes in
test_torch_rce_device_mask.py and ``batched_rce`` in
test_torch_rce_device_batched.py (files of their own, so that the test
workers run them side by side).
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


def _check_objective(got, want):
    xm, dFdt, dTdt, aux = got
    xm_r, dFdt_r, dTdt_r, aux_r = (np.asarray(a) if not isinstance(a, dict) else a
                                   for a in want)
    np.testing.assert_allclose(xm[0].numpy(), xm_r, rtol=1e-12)
    scale = np.max(np.abs(np.asarray(aux_r["f_total"])))
    np.testing.assert_allclose(aux["f_total"][0].numpy(), np.asarray(aux_r["f_total"]),
                               rtol=1e-9, atol=1e-10 * scale)
    np.testing.assert_allclose(dFdt[0].numpy(), dFdt_r, rtol=1e-9, atol=1e-10 * scale)
    rows = np.abs(dFdt_r) > 0
    unit = np.max(np.abs(dTdt_r[rows] / dFdt_r[rows])) if rows.any() else 1.0
    np.testing.assert_allclose(dTdt[0].numpy(), dTdt_r, rtol=1e-9, atol=1e-10 * scale * unit)
    for k in ("lr_intended", "lr_actual", "dz", "P_c", "f_c"):
        np.testing.assert_allclose(aux[k][0].numpy(), np.asarray(aux_r[k]), rtol=1e-9,
                                   atol=1e-300, err_msg=k)


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_objective_matches_reference(models, ref_fns, mask_name):
    ref, c = models
    P_i, mask = earth_like_P_i(c), MASKS[mask_name]
    fns = rce_device.build_rce_fns(c)
    got = _port_objective(fns, c, T_RAMP, mask, P_i)
    want = ref_fns["objective"](jnp.asarray(T_RAMP), jnp.asarray(mask), jnp.asarray(P_i))
    _check_objective(got, want)


def test_objective_lanes_are_independent(models):
    """The four masks as one B=4 batch equal four B=1 evaluations, rtol 1e-12."""
    _, c = models
    fns = rce_device.build_rce_fns(c)
    P_i = earth_like_P_i(c)
    masks = np.array(list(MASKS.values()))
    B = len(masks)
    got = fns["objective"](*(torch.as_tensor(a) for a in (
        np.repeat(T_RAMP[None], B, 0), masks, np.repeat(P_i[None], B, 0))))
    for b, mask in enumerate(masks):
        one = _port_objective(fns, c, T_RAMP, mask, P_i)
        for g, w in zip(got[:3], one[:3]):
            np.testing.assert_allclose(g[b].numpy(), w[0].numpy(), rtol=1e-12, atol=1e-300)


@pytest.fixture()
def tidally_locked(models):
    for m in models:
        m.tidally_locked_dayside = True
        m.compute_solar_in_jac = True
    try:
        yield models
    finally:
        for m in models:
            m.tidally_locked_dayside = False
            m.compute_solar_in_jac = False


def test_tidally_locked_objective_and_jacobian_match_reference(tidally_locked):
    """The Koll 4f enhancement in the objective, and its per-perturbation
    re-evaluation in the Jacobian (compute_solar_in_jac)."""
    ref, c = tidally_locked
    P_i, mask = earth_like_P_i(c), MASKS["ground_zone"]
    ref_fns = _jitted(ref_rce_device.build_rce_fns(ref))
    fns = rce_device.build_rce_fns(c)
    want = ref_fns["objective"](jnp.asarray(T_RAMP), jnp.asarray(mask), jnp.asarray(P_i))
    got = _port_objective(fns, c, T_RAMP, mask, P_i)
    _check_objective(got, want)
    enh = float(got[3]["enh"][0])
    np.testing.assert_allclose(enh, float(want[3]["enh"]), rtol=1e-9)
    assert enh != 1.0
    J_want = np.asarray(ref_fns["jacobian"](want[0], jnp.asarray(mask), want[3], want[2]))
    J_got = fns["jacobian"](got[0], torch.as_tensor(mask[None]), got[3], got[2])[0].numpy()
    np.testing.assert_allclose(J_got, J_want, rtol=1e-8, atol=2e-11)
