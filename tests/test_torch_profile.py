"""Profile and altitude cores of the PyTorch port against clima_tpu
(float64, CPU): the moist-adiabat march batched over columns against the JAX
package's per-column make_profile_core, the hydrostatic altitude solve with
and without reference_pressure, and the dry prescribed profile, at rtol 1e-10."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clima_tpu.adiabat import profile as ref_profile
from clima_tpu.adiabat.altitude import compute_altitude_core as ref_altitude
from clima_tpu.adiabat.profile_dry import make_profile_dry_core as ref_dry
from clima_tpu.config import load_species as ref_load_species
from clima_tpu.data import write_species_yaml

from clima_tpu_torch.adiabat import profile
from clima_tpu_torch.adiabat.altitude import compute_altitude_core
from clima_tpu_torch.adiabat.profile_dry import make_profile_dry_core
from clima_tpu_torch.config import load_species

RTOL = 1e-10
NZ, P_TOP, SUBSTEPS = 12, 10.0, 4
MASS, RADIUS = 5.972e27, 6.371e8


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("sp") / "species.yaml")
    write_species_yaml(p)
    ref_sp, sp = ref_load_species(p), load_species(p)
    ref = ref_profile.AdiabatParams(
        gas_masses=jnp.asarray(ref_sp.gas_masses), thermo=ref_sp.thermo, sat=ref_sp.sat,
        nz=NZ, planet_mass=MASS, planet_radius=RADIUS, P_top=P_TOP, substeps=SUBSTEPS)
    par = profile.AdiabatParams.from_species(sp, NZ, MASS, RADIUS, P_TOP, SUBSTEPS, "cpu")
    return ref, par, sp.gas_names


def _columns(names):
    """The cases of tests/test_profile.py: an ocean world with a tropopause
    (H2O condensing at the surface), a column crossing H2O's triple point (a
    latent-heat kink), and subsaturated H2O that saturates aloft."""
    ng = len(names)
    iH2O, iCO2, iN2 = names.index("H2O"), names.index("CO2"), names.index("N2")
    P_i = np.full((3, ng), 1e-15)
    P_i[0, iH2O], P_i[0, iN2] = 10.0e6, 1.0e6
    P_i[1, iH2O], P_i[1, iCO2], P_i[1, iN2] = 270.0e6, 400.0, 1.0e6
    P_i[2, iH2O], P_i[2, iN2] = 0.01e6, 1.0e6
    return np.array([320.0, 285.0, 320.0]), P_i, np.array([180.0, 180.0, 150.0])


@pytest.fixture(scope="module")
def profiles(params):
    ref, par, names = params
    T_surf, P_i, T_trop = _columns(names)
    RH = np.ones(len(names))
    got = profile.make_profile_core(par, torch.tensor(RH), torch.tensor(T_surf),
                                    torch.tensor(P_i), torch.tensor(T_trop))
    want = [ref_profile.make_profile_core(ref, jnp.asarray(RH), T_surf[b], jnp.asarray(P_i[b]),
                                          T_trop[b]) for b in range(3)]
    return got, want


def test_make_profile_core_matches_reference(profiles, params):
    got, want = profiles
    names = params[2]
    for b, w in enumerate(want):
        for k in ("P_e", "T_e", "z_e", "f_i_e", "P_trop", "N_surface", "P_surf", "r_dry"):
            np.testing.assert_allclose(got[k][b].numpy(), np.asarray(w[k]), rtol=RTOL,
                                       atol=1e-300, err_msg=f"column {b} {k}")
        np.testing.assert_array_equal(got["mask_surf"][b].numpy(), np.asarray(w["mask_surf"]))
    iH2O = names.index("H2O")
    T_e, f_e = got["T_e"].numpy(), got["f_i_e"].numpy()
    assert (got["P_trop"].numpy()[:2] > 0).all()  # tropopauses reached
    assert T_e[1].max() > 273.16 > T_e[1].min()  # crosses H2O's triple point
    assert not got["mask_surf"][2, iH2O] and f_e[2, -1, iH2O] < f_e[2, 0, iH2O]  # saturates aloft


def test_profile_pieces_match_reference(profiles, params):
    """mixing_ratios, lapse_rate_moist, update_mask and the surface split at
    one level of each column."""
    ref, par, names = params
    got, _ = profiles
    ng = len(names)
    T_surf, P_i, _ = _columns(names)
    RH = np.full(ng, 0.9)
    lev = 5
    P, T = got["P_e"][:, lev], got["T_e"][:, lev]
    split = profile.surface_classification(par, torch.tensor(RH), torch.tensor(T_surf),
                                           torch.tensor(P_i))
    for b in range(3):
        ref_split = ref_profile.surface_classification(ref, jnp.asarray(RH), T_surf[b],
                                                       jnp.asarray(P_i[b]))
        for g, w in zip(split, ref_split):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=1e-12)
    mask, r_dry = split[2], split[3]
    mask = mask.clone()
    mask[1] = False  # an emptier condensing set for update_mask to grow
    f_i, f_dry = profile.mixing_ratios(par, torch.tensor(RH), mask, r_dry, P, T)
    lapse = profile.lapse_rate_moist(par, torch.tensor(RH), mask, r_dry, P, T)
    grown = profile.update_mask(par, torch.tensor(RH), mask, r_dry, P, T)
    for b in range(3):
        args = (ref, jnp.asarray(RH), jnp.asarray(mask[b].numpy()), jnp.asarray(r_dry[b].numpy()),
                float(P[b]), float(T[b]))
        wf, wd = ref_profile.mixing_ratios(*args)
        np.testing.assert_allclose(f_i[b].numpy(), np.asarray(wf), rtol=1e-12)
        np.testing.assert_allclose(float(f_dry[b]), float(wd), rtol=1e-12)
        np.testing.assert_allclose(float(lapse[b]), float(ref_profile.lapse_rate_moist(*args)),
                                   rtol=1e-12)
        np.testing.assert_array_equal(grown[b].numpy(), np.asarray(ref_profile.update_mask(*args)))


@pytest.mark.parametrize("reference_pressure", [-1.0, 3.0e5])
def test_compute_altitude_core_matches_reference(profiles, params, reference_pressure):
    ref, par, _ = params
    got, _ = profiles
    P, T = got["P_e"][:, 1::2], got["T_e"][:, 1::2]
    mubar = torch.sum(got["f_i_e"][:, 1::2] * par.gas_masses, dim=-1)
    mubar_surf = torch.sum(got["f_i_e"][:, 0] * par.gas_masses, dim=-1)
    T_surf = got["T_e"][:, 0]
    out = compute_altitude_core(P, T, mubar, got["P_surf"], T_surf, mubar_surf, P_TOP, MASS,
                                RADIUS, reference_pressure)
    for b in range(3):
        want = ref_altitude(*(jnp.asarray(x[b].numpy()) for x in (P, T, mubar)),
                            float(got["P_surf"][b]), float(T_surf[b]), float(mubar_surf[b]),
                            P_TOP, MASS, RADIUS, reference_pressure)
        for k in ("z", "dz", "gravity", "gravity_surf", "z_e"):
            np.testing.assert_allclose(out[k][b].numpy(), np.asarray(want[k]), rtol=RTOL,
                                       atol=1e-300, err_msg=f"column {b} {k}")


def test_make_profile_dry_core_matches_reference(profiles, params):
    """The dry constructor on the moist profiles' own (P, T, f_i) columns."""
    ref, par, _ = params
    got, _ = profiles
    P, T, f = got["P_e"][:, ::3], got["T_e"][:, ::3], got["f_i_e"][:, ::3]
    out = make_profile_dry_core(par, P, T, f)
    for b in range(3):
        want = ref_dry(ref, *(jnp.asarray(x[b].numpy()) for x in (P, T, f)))
        for k in ("P_e", "T_e", "z_e", "f_i_e", "lapse_rate_e"):
            np.testing.assert_allclose(out[k][b].numpy(), np.asarray(want[k]), rtol=RTOL,
                                       err_msg=f"column {b} {k}")
