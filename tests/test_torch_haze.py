"""A prescribed haze through the port's RCE paths (float64, CPU).

One synthetic template with particles (nz=8, 1 zenith angle, substeps 2) and
the 10 cm^-3 haze of tests/test_rce_device.py's
test_batched_rce_with_particles_matches_host, set on both models with
``set_particle_density_and_radii``; the port's model gets the JAX model's
opacity tables and free parameters (AdiabatClimate.from_reference). The
port's host RCE runs once, from its surface_temperature warm start (~60 s on
one CPU core: with the haze it takes ~100 objective evaluations).

- The port's host RCE solution held to the JAX package's jitted
  ``build_rce_fns`` objective at that state (mask, T_surf, T): the JAX
  model's per-edge net fluxes equal the port's there (rtol 1e-9, atol 1e-10
  of the flux scale), and its residual max|F/F0| is below 10 xtol_rc (the
  energy balance tests/test_rce.py checks). Marked slow (~36 s more): the
  JAX host RCE itself from the same warm start, the same mask, T_surf and T
  at rtol 1e-6.
- The port's ``batched_rce`` at B=1 against the port's host RCE (the same
  mask, T_surf within 0.5 K and T within 2 K, tests/test_rce_device.py's
  limits for device against host RCE), started from the host RCE's
  solution, where it must stay (status 0). Marked slow (~190 objective
  evaluations, ~150 s): the same from the surface_temperature warm start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.adiabat import rce_device as ref_rce_device
from clima_tpu.data import make_template_dir

from clima_tpu_torch.adiabat import AdiabatClimate, rce, rce_device
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, SUBSTEPS = 8, 2
HAZE_P = np.geomspace(2.0e6, 1.0, 8)  # tests/test_rce_device.py's haze nodes


def _files(t):
    return t["species"], t["settings"], t["star"], t["datadir"]


def _set_haze(c):
    n = len(c.particle_names)
    c.set_particle_density_and_radii(HAZE_P, np.full((8, n), 1.0e1), np.full((8, n), 1.0e-5))


def earth_like_P_i(c):
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0
    P_i[c.species_names.index("N2")] = 1.0e6
    return P_i


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    t = make_template_dir(str(tmp_path_factory.mktemp("haze")), nz=NZ, n_zenith=1,
                          particles=True)
    ref = RefAdiabatClimate(*_files(t), substeps=SUBSTEPS)
    ref.verbose = False
    _set_haze(ref)
    c = AdiabatClimate.from_reference(ref, *_files(t), device="cpu")
    c.verbose = False
    _set_haze(c)
    assert len(c.particle_names) > 0
    np.testing.assert_array_equal(c._particle_log10_dens, ref._particle_log10_dens)
    return ref, c


@pytest.fixture(scope="module")
def warm_start(models):
    """The port's surface_temperature solution: (P_i, T_surf, T)."""
    _, c = models
    P_i = earth_like_P_i(c)
    T_surf = c.surface_temperature(P_i, T_guess=280.0)
    return P_i, T_surf, c.T.copy()


@pytest.fixture(scope="module")
def host_rce(models, warm_start):
    """The port's host RCE from the warm start: (P_i, converged, T_surf, T,
    mask)."""
    _, c = models
    P_i, T_surf0, T0 = warm_start
    converged = c.RCE(P_i, T_surf0, T0.copy())
    return P_i, converged, float(c.T_surf), c.T.copy(), c.convecting_with_below.copy()


def test_host_rce_with_haze_matches_reference(models, host_rce):
    ref, c = models
    P_i, converged, T_surf, T, mask = host_rce
    assert converged
    assert mask.any() and not mask.all()
    x_model = np.concatenate([[T_surf], T])
    objective = jax.jit(ref_rce_device.build_rce_fns(ref)["objective"])
    _, dFdt, _, aux = objective(jnp.asarray(x_model), jnp.asarray(mask), jnp.asarray(P_i))
    want = np.asarray(aux["f_total"])
    # the port's net fluxes at its own solution
    x = np.array([T_surf] + [T[ind - 2] for ind in c._inds_Tx[1:]])
    rce._objective(c, P_i, x)
    got = rce._f_total_edges_precise(c)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10 * scale)
    ratio = rce._flux_metrics(c, np.asarray(dFdt))[1]
    print(f"haze RCE: T_surf {T_surf:.9f} K, mask {mask.astype(int)}, JAX max|F/F0| there "
          f"{ratio:.3e}")
    assert ratio < 10 * c.xtol_rc


@pytest.mark.slow
def test_host_rce_with_haze_matches_reference_rce(models, warm_start, host_rce):
    ref, _ = models
    P_i, T_surf0, T0 = warm_start
    _, converged, T_surf, T, mask = host_rce
    assert converged and ref.RCE(P_i, T_surf0, T0.copy())
    np.testing.assert_array_equal(mask, ref.convecting_with_below)
    print(f"haze RCE against the JAX host RCE: |dT_surf| {abs(T_surf - ref.T_surf):.3e} K, "
          f"max |dT| {np.max(np.abs(T - ref.T)):.3e} K")
    assert T_surf == pytest.approx(ref.T_surf, rel=1e-6)
    np.testing.assert_allclose(T, ref.T, rtol=1e-6)


def _batched_against_host(c, host_rce, T_surf_start, T_start):
    P_i, converged, T_surf, T, mask = host_rce
    assert converged
    out = rce_device.batched_rce(c, P_i[None, :], np.array([T_surf_start]), T_start[None, :])
    assert bool(out["converged"][0]) and int(out["status"][0]) == 0
    dT_surf = abs(float(out["T_surf"][0]) - T_surf)
    dT = float(np.max(np.abs(out["T"][0].numpy() - T)))
    print(f"batched haze RCE against host: |dT_surf| {dT_surf:.3e} K, max |dT| {dT:.3e} K")
    assert dT_surf < 0.5
    assert dT < 2.0
    np.testing.assert_array_equal(out["convecting_with_below"][0].numpy(), mask)


def test_batched_rce_with_haze_matches_host_rce(models, host_rce):
    _, T_surf, T = host_rce[1:4]
    _batched_against_host(models[1], host_rce, T_surf, T)


@pytest.mark.slow
def test_batched_rce_with_haze_from_the_warm_start(models, warm_start, host_rce):
    _batched_against_host(models[1], host_rce, *warm_start[1:])
