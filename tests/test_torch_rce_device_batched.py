"""``batched_rce`` of the PyTorch port (clima_tpu_torch.adiabat.rce_device)
against clima_tpu's host RCE (float64, CPU).

On test_torch_rce_device.py's template and models (nz=8, 1 zenith angle,
surface albedo 0.3, substeps 2; AdiabatClimate.from_reference):

- ``batched_rce`` at B=2 (CO2 x1.0, x1.1) from the JAX package's
  surface_temperature warm start: every lane status 0, and each lane against
  the JAX package's host RCE on its own inputs, the same mask, T_surf within
  0.5 K and T within 2 K (tests/test_rce_device.py's limits for the JAX
  package's own device solver; the gaps are printed). Lanes are independent:
  a lane's result does not move with its partner's data (rtol 1e-12), and
  B=2 equals two B=1 runs to rtol 1e-7 (see that test for why not 1e-12 on
  the CPU). ``chunk_iters`` reaches the same fixed point. (``mesh`` is
  tested in test_torch_distributed.py.)
- Slow: against the JAX package's ``batched_rce`` itself (converged, status
  and masks equal, T at rtol 1e-6; the JAX side traces and compiles its
  vmapped program for several minutes).
"""


import numpy as np
import pytest
import torch

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.adiabat import rce_device as ref_rce_device
from clima_tpu.data import make_template_dir

from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.adiabat import rce_device
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, SUBSTEPS = 8, 2
CO2_SCALES = (1.0, 1.1)


def _files(t):
    return t["species"], t["settings"], t["star"], t["datadir"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    t = make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=NZ, n_zenith=1,
                          surface_albedo=0.3)
    ref = RefAdiabatClimate(*_files(t), substeps=SUBSTEPS)
    ref.verbose = False
    return ref, AdiabatClimate.from_reference(ref, *_files(t), device="cpu")


def earth_like_P_i(c, co2_scale=1.0):
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0 * co2_scale
    P_i[c.species_names.index("N2")] = 1.0e6
    return P_i


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
