"""Thermodynamics of the PyTorch port against clima_tpu (float64, CPU):
heat capacities, latent heats, saturation pressures and their T-derivative,
across the triple and critical points, at rtol 1e-12."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from clima_tpu.config import load_species as ref_load_species
from clima_tpu.config.species import heat_capacity as ref_heat_capacity
from clima_tpu.data import write_species_yaml
from clima_tpu.physics import saturation as ref_sat

from clima_tpu_torch.config import load_species
from clima_tpu_torch.config.species import heat_capacity
from clima_tpu_torch.physics import saturation

RTOL = 1e-12


@pytest.fixture(scope="module")
def species(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("sp") / "species.yaml")
    write_species_yaml(p)
    ref = ref_load_species(p)
    sp = load_species(p)
    return ref, sp, saturation.SaturationParams.from_gas_list(sp.sat).to("cpu")


def _temperatures(ref):
    """Temperatures on both sides of every triple and critical point, inside
    and outside the thermodynamic tables' ranges."""
    sat = ref.sat
    edges = np.concatenate([np.asarray(sat.T_triple)[np.asarray(sat.has_sat)],
                            np.asarray(sat.T_critical)[np.asarray(sat.has_sat)]])
    near = np.concatenate([edges - 0.5, edges, edges + 0.5])
    return np.concatenate([np.linspace(60.0, 900.0, 37), near, [20.0, 7000.0]])


def _ref_per_T(fn, Ts):
    """The JAX function (scalar T -> (ng,)) at each temperature."""
    return np.stack([np.asarray(fn(jnp.asarray(T))) for T in Ts])


def test_heat_capacity_matches_reference(species):
    ref, sp, _ = species
    Ts = _temperatures(ref)
    want = _ref_per_T(lambda T: ref_heat_capacity(ref.thermo, T), Ts)
    got = heat_capacity(sp.thermo.to("cpu"), torch.tensor(Ts)).numpy()
    assert got.shape == (len(Ts), sp.ng)
    # NaN outside the tables' ranges, in the same places
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() and np.isfinite(got).any()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # host tables are moved to T's device on the fly
    np.testing.assert_array_equal(heat_capacity(sp.thermo, torch.tensor(Ts)).numpy(), got)


@pytest.mark.parametrize("pinned", [False, True])
def test_sat_pressure_and_latent_heat_match_reference(species, pinned):
    """Both regimes on each side of T_triple and T_critical; with ``pinned``
    the regime is chosen by a branch temperature on the other side."""
    ref, sp, sat = species
    Ts = _temperatures(ref)
    Tb = Ts + np.where(np.arange(len(Ts)) % 2, 3.0, -3.0) if pinned else None
    for name in ("sat_pressure", "latent_heat"):
        rfn = getattr(ref_sat, name)
        if pinned:
            want = np.stack([np.asarray(rfn(ref.sat, jnp.asarray(T), jnp.asarray(b)))
                             for T, b in zip(Ts, Tb)])
        else:
            want = _ref_per_T(lambda T: rfn(ref.sat, T), Ts)
        got = getattr(saturation, name)(sat, torch.tensor(Ts),
                                        None if Tb is None else torch.tensor(Tb)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)


def test_sat_pressure_derivative_matches_reference(species):
    """The closed form against the JAX package's forward-mode AD."""
    ref, _, sat = species
    Ts = np.concatenate([np.linspace(100.0, 700.0, 41), [273.4, 304.5, 216.9]])
    want = _ref_per_T(lambda T: ref_sat.sat_pressure_derivative(ref.sat, T), Ts)
    got = saturation.sat_pressure_derivative(sat, torch.tensor(Ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # and against a centred difference of the port's own sat_pressure
    h = 1e-4
    fd = (saturation.sat_pressure(sat, torch.tensor(Ts + h), torch.tensor(Ts))
          - saturation.sat_pressure(sat, torch.tensor(Ts - h), torch.tensor(Ts))) / (2 * h)
    cond = np.asarray(ref.sat.has_sat)
    np.testing.assert_allclose(got[:, cond], fd.numpy()[:, cond], rtol=1e-6)


def test_saturation_params_from_gas_list_match_reference(species):
    ref, sp, sat = species
    host = saturation.SaturationParams.from_gas_list(sp.sat)
    for f in ("has_sat", "mu", "T_ref", "P_ref", "T_triple", "T_critical",
              "a_v", "b_v", "a_s", "b_s", "a_c", "b_c"):
        np.testing.assert_array_equal(getattr(host, f), np.asarray(getattr(ref.sat, f)), f)
        np.testing.assert_array_equal(getattr(sat, f).numpy(), np.asarray(getattr(ref.sat, f)), f)
    assert jax.config.jax_enable_x64
