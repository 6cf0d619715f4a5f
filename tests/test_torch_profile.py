"""Profile and altitude cores of the PyTorch port against clima_tpu
(float64, CPU): the moist-adiabat march batched over columns against the JAX
package's per-column make_profile_core, the hydrostatic altitude solve with
and without reference_pressure, and the dry prescribed profile, at rtol 1e-10.
Also the march kernel's packed per-gas tables (ops/march_cuda.py) against the
saturation and heat-capacity models, and its wrapper's place among the
program's counters (the kernel itself runs on the card: test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clima_tpu.adiabat import profile as ref_profile
from clima_tpu.adiabat.altitude import compute_altitude_core as ref_altitude
from clima_tpu.adiabat.profile_dry import make_profile_dry_core as ref_dry
from clima_tpu.config import load_species as ref_load_species
from clima_tpu.data import write_species_yaml

from clima_tpu_torch import constants as const
from clima_tpu_torch.adiabat import profile
from clima_tpu_torch.adiabat.altitude import compute_altitude_core
from clima_tpu_torch.adiabat.profile_dry import make_profile_dry_core
from clima_tpu_torch.config import heat_capacity, load_species
from clima_tpu_torch.ops import march_cuda
from clima_tpu_torch.physics import saturation
from clima_tpu_torch.utils import profiling
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


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


def test_march_tables_read_as_the_models(params):
    """The march kernel's per-gas rows, read as a lane reads its own
    (march_cuda.sat_pressure_ref, heat_capacity_ref), give
    saturation.sat_pressure in each condensible gas's three regimes (bitwise)
    and heat_capacity in every range of every gas (rtol 1e-14: the
    polynomial's terms are summed in another order), NaN outside the edges;
    the constants are the numbers the twin's expressions form. The tables
    are packed once per AdiabatParams."""
    _, par, _ = params
    tables, consts = par.march_tables
    assert par.march_tables[0] is tables
    assert dataclasses.replace(par, P_top=2.0).march_tables[0] is not tables
    ng, nr = tables.shape[0], par.thermo.temps.shape[1] - 1
    assert tables.shape == (ng, 22 + 8 * nr) and tables.dtype == torch.float64
    T = torch.tensor([120.0, 200.0, 216.58, 250.0, 273.15, 290.0, 304.13, 400.0, 647.0, 700.0,
                      999.0, 1000.0, 1250.0, 1300.0, 1700.0, 2000.0, 2500.0, 3000.0, 5999.0,
                      6000.0, 7000.0])
    sat = par.sat
    regime = (T[:, None] > sat.T_triple).long() + (T[:, None] >= sat.T_critical).long()
    for g in np.flatnonzero(sat.has_sat.numpy()):
        assert set(regime[:, g].tolist()) == {0, 1, 2}, g
    torch.testing.assert_close(march_cuda.sat_pressure_ref(tables, T),
                               saturation.sat_pressure(sat, T), rtol=0, atol=0)
    edges = par.thermo.temps
    rng = torch.sum(T[:, None, None] >= edges[:, :-1], dim=-1) - 1
    inside = (T[:, None] >= edges[:, 0]) & (T[:, None] < edges[:, -1])
    for g in range(ng):
        n_g = int(torch.unique(edges[g]).numel()) - 1  # the gas's own ranges
        assert set(rng[inside[:, g], g].tolist()) >= set(range(n_g)), g
    assert not inside.all(axis=0).any()
    got = march_cuda.heat_capacity_ref(tables, nr, T)
    want = heat_capacity(par.thermo, T)
    assert torch.equal(torch.isnan(got), ~inside) and torch.equal(torch.isnan(want), ~inside)
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0, equal_nan=True)
    assert consts.tolist() == [const.Rgas, const.Rgas_si, const.G_grav * (MASS / 1.0e3), RADIUS,
                               const.N_avo * const.k_boltz, profile.G_GRAV_CGS * MASS,
                               saturation.BIG, profile.F_DRY_MIN]


def test_march_kernel_wrapper_is_counted_and_refuses_the_cpu(params):
    """The march wrapper's launches are among the program's counters; it
    refuses CPU tensors, and make_profile_core on the CPU runs the twin and
    launches nothing."""
    _, par, names = params
    assert profiling._counters()["launches"]["moist_adiabat_march_cuda"] == \
        march_cuda.moist_adiabat_march_cuda.launches
    par = dataclasses.replace(par, nz=2, substeps=1)
    T_surf, P_i, T_trop = (torch.tensor(x[:1]) for x in _columns(names))
    RH = torch.ones(len(names), dtype=torch.float64)
    n = march_cuda.moist_adiabat_march_cuda.launches
    out = profile.make_profile_core(par, RH, T_surf, P_i, T_trop)
    assert march_cuda.moist_adiabat_march_cuda.launches == n
    s = profile._start(par, RH, T_surf, P_i, T_trop)
    with pytest.raises(ValueError, match="CUDA device"):
        march_cuda.moist_adiabat_march_cuda(par, RH, T_surf, s.T_trop, s.mask0, s.r_dry, s.P_e,
                                            s.f_i_surf)
    assert out["T_e"].shape == (1, 5) and out["f_i_e"].shape == (1, 5, len(names))
