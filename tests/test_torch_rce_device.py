"""Batched RCE of the PyTorch port (clima_tpu_torch.adiabat.rce_device) against
clima_tpu's (float64, CPU).

One synthetic template (nz=8, 1 zenith angle, surface albedo 0.3, substeps
2); the port's model gets the JAX model's opacity tables and free parameters
(AdiabatClimate.from_reference). The JAX side is the JAX package's
``build_rce_fns``, its objective and Jacobian jitted once per model, and its
host ``RCE``.

- The objective on the four masks of tests/test_rce_device.py (cut to nz=8),
  at T = linspace(285, 205): rtol 1e-9, with an atol of 1e-10 of the flux
  scale (dTdt: that over the smallest heat capacity's ratio). At these
  states the two packages' net fluxes differ by up to 1.4e-11 of the flux
  scale (the host objectives of both packages too: ulp differences of exp
  in the two-stream terms, summed over the bins); where the residuals cancel
  to a small value they keep that absolute error.
- The zone-block FD Jacobian unchunked and at jac_chunk 1 and 7: against the
  JAX package at rtol 1e-8 with tests/test_rce_device.py's own FD floor
  (atol 2e-11, the residual's noise over delta), and against the port's
  unchunked Jacobian at rtol 1e-8, atol 1e-12.
- The mask limiter on random masks and the three mask-update modes on fixed
  states: the same masks and locks.
- The tidally locked objective and Jacobian (compute_solar_in_jac on).
- ``batched_rce`` at B=2 (CO2 x1.0, x1.1) from the JAX package's
  surface_temperature warm start: every lane status 0, and each lane against
  the JAX package's host RCE on its own inputs, the same mask, T_surf within
  0.5 K and T within 2 K (tests/test_rce_device.py's limits for the JAX
  package's own device solver; the gaps are printed). Lanes are independent:
  a lane's result does not move with its partner's data (rtol 1e-12), and
  B=2 equals two B=1 runs to rtol 1e-7 (see that test for why not 1e-12 on
  the CPU). ``chunk_iters`` reaches the same fixed point; ``mesh`` raises.
- Slow: against the JAX package's ``batched_rce`` itself (converged, status
  and masks equal, T at rtol 1e-6; the JAX side traces and compiles its
  vmapped program for several minutes).
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

NZ, SUBSTEPS = 8, 2
T_RAMP = np.linspace(285.0, 205.0, NZ + 1)
CO2_SCALES = (1.0, 1.1)

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


# mode -> (state x, mask before the update, lock): states where each mode
# changes the mask (mode 1 retracts the zone, mode 2 promotes two layers,
# mode 3 retracts a zone top and counts the locks down)
X_SUPER = np.array([300.0, 295.0, 290.0, 240.0, 230.0, 220.0, 210.0, 200.0, 190.0])
UPDATE_STATES = {
    1: (X_SUPER, np.arange(NZ) < 2, np.zeros(NZ, np.int64)),
    2: (np.array([300.0, 240.0] + [150.0] * (NZ - 1)), np.zeros(NZ, bool),
        np.zeros(NZ, np.int64)),
    3: (X_SUPER, MASKS["two_zones"], np.array([0, 2, 0, 0, 1, 0, 0, 0])),
}


@pytest.fixture(scope="module")
def ref_update_mask(ref_fns):
    return jax.jit(ref_fns["update_mask"])


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_update_mask_matches_reference(models, ref_update_mask, mode):
    """Each mode's update at a fixed state: the same mask and lock."""
    ref, c = models
    P_i = earth_like_P_i(c)
    x, save, lock = UPDATE_STATES[mode]
    want = ref_update_mask(jnp.asarray(mode), jnp.asarray(x), jnp.asarray(save),
                           jnp.asarray(lock, jnp.int32), jnp.asarray(P_i))
    fns = rce_device.build_rce_fns(c)
    got = fns["update_mask"](torch.tensor([mode]), *_batch(c, x, save, lock, P_i))
    assert (np.asarray(want[0]) != save).any()  # the state exercises the mode
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))


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


@pytest.fixture(scope="module")
def warm_start(models):
    """The JAX package's surface_temperature solution: (T_surf, T)."""
    ref, _ = models
    T_surf = ref.surface_temperature(earth_like_P_i(ref), T_guess=280.0)
    return T_surf, ref.T.copy()


def _lanes_P_i(c):
    return np.array([earth_like_P_i(c, s) for s in CO2_SCALES])


def _rce(c, P_i_b, warm, **kwargs):
    T_surf, T = warm
    B = P_i_b.shape[0]
    return rce_device.batched_rce(c, P_i_b, np.full(B, T_surf), np.repeat(T[None], B, 0),
                                  **kwargs)


@pytest.fixture(scope="module")
def batched(models, warm_start):
    _, c = models
    return _rce(c, _lanes_P_i(c), warm_start)


@pytest.mark.parametrize("lane", [0, 1])
def test_batched_rce_matches_host_rce(models, warm_start, batched, lane):
    """Each lane against the JAX package's host RCE on the lane's inputs."""
    ref, c = models
    out = batched
    assert bool(out["converged"][lane]) and int(out["status"][lane]) == 0
    assert float(out["max_ratio"][lane]) < c.xtol_rc
    assert float(out["ratio_floor"][lane]) < c.xtol_rc
    assert out["residual_dFdt"].shape == (len(CO2_SCALES), NZ + 1)
    T_surf0, T0 = warm_start
    assert ref.RCE(earth_like_P_i(ref, CO2_SCALES[lane]), T_surf0, T0.copy())
    dT_surf = float(out["T_surf"][lane]) - ref.T_surf
    dT = np.max(np.abs(out["T"][lane].numpy() - ref.T))
    print(f"lane {lane}: T_surf {float(out['T_surf'][lane]):.6f} K, host {ref.T_surf:.6f} K, "
          f"gap {dT_surf:.3e} K; max |dT| {dT:.3e} K")
    np.testing.assert_array_equal(out["convecting_with_below"][lane].numpy(),
                                  ref.convecting_with_below)
    assert abs(dT_surf) < 0.5
    assert dT < 2.0


def test_batched_rce_lanes_are_independent(models, warm_start, batched):
    """A lane's result does not depend on the other lanes: lane 0 of
    [a, b] equals lane 0 of [a, a] to rtol 1e-12 (lane b takes its own path,
    and the loops run until both lanes stop). Against a B=1 run the same
    lane agrees to rtol 1e-7, with the same mask, status and iterations: on
    the CPU, PyTorch's vectorised pow rounds its SIMD body and its scalar
    tail differently, so a lane's opacity moves by an ulp with its position
    in the batch, and the Newton steps carry that through the FD Jacobian's
    condition number (measured: 5.1e-9 relative in T)."""
    _, c = models
    P_i_b = _lanes_P_i(c)
    same = _rce(c, P_i_b[[0, 0]], warm_start)
    for k in ("T_surf", "T", "max_ratio", "P", "z", "f_total"):
        np.testing.assert_allclose(batched[k][0].numpy(), same[k][0].numpy(), rtol=1e-12,
                                   atol=1e-300, err_msg=k)
    for lane in range(len(CO2_SCALES)):
        one = _rce(c, P_i_b[lane:lane + 1], warm_start)
        for k in ("convecting_with_below", "converged", "status", "rc_iters", "solve_iters"):
            np.testing.assert_array_equal(batched[k][lane].numpy(), one[k][0].numpy(),
                                          err_msg=k)
        for k in ("T_surf", "T", "P", "z"):
            np.testing.assert_allclose(batched[k][lane].numpy(), one[k][0].numpy(), rtol=1e-7,
                                       err_msg=k)


def test_batched_rce_chunk_iters_reaches_the_same_fixed_point(models, warm_start, batched):
    """Passes of at most 2 solver iterations, each warm-restarted: the same
    mask and status, T within the convergence tolerance's reach."""
    _, c = models
    out = _rce(c, _lanes_P_i(c)[:1], warm_start, chunk_iters=2)
    assert int(out["status"][0]) == 0
    assert int(out["solve_iters"][0]) >= int(batched["solve_iters"][0])
    np.testing.assert_array_equal(out["convecting_with_below"][0].numpy(),
                                  batched["convecting_with_below"][0].numpy())
    np.testing.assert_allclose(out["T"][0].numpy(), batched["T"][0].numpy(), atol=0.05)
    assert abs(float(out["T_surf"][0]) - float(batched["T_surf"][0])) < 0.05


def test_batched_rce_mesh_raises(models):
    _, c = models
    P_i = earth_like_P_i(c)[None]
    with pytest.raises(NotImplementedError, match="mesh"):
        rce_device.batched_rce(c, P_i, [280.0], T_RAMP[None, 1:], mesh=object())


def test_result_keys_match_reference(models, batched):
    ref_keys = {"T_surf", "T", "convecting_with_below", "converged", "status", "solve_diag",
                "ratio_best", "ratio_floor", "residual_dFdt", "rc_iters", "solve_iters",
                "max_ratio", "P", "f_i", "dz", "z", "P_surf", "N_surface", "f_total"}
    assert set(batched) == ref_keys
    assert set(batched["solve_diag"]) == {"ratio_best", "it_total", "out_of_stages"}


@pytest.mark.slow
def test_batched_rce_matches_reference_batched_rce(models, warm_start, batched):
    """The JAX package's batched_rce on the same lanes (it traces and compiles
    its vmapped program for several minutes on the CPU)."""
    ref, c = models
    T_surf, T = warm_start
    B = len(CO2_SCALES)
    want = ref_rce_device.batched_rce(ref, _lanes_P_i(ref), np.full(B, T_surf),
                                      np.repeat(T[None], B, 0))
    for k in ("converged", "status", "convecting_with_below"):
        np.testing.assert_array_equal(batched[k].numpy(), np.asarray(want[k]), err_msg=k)
    gap = np.max(np.abs(batched["T"].numpy() - np.asarray(want["T"])))
    print(f"max |T - T_ref| {gap:.3e} K; T_surf gaps "
          f"{batched['T_surf'].numpy() - np.asarray(want['T_surf'])}")
    np.testing.assert_allclose(batched["T"].numpy(), np.asarray(want["T"]), rtol=1e-6)
    np.testing.assert_allclose(batched["T_surf"].numpy(), np.asarray(want["T_surf"]), rtol=1e-6)
