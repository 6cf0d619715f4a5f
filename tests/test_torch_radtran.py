"""The Radtran slice of the PyTorch port against clima_tpu (float64, CPU):
compute_opacity on identical tables, the batched form against single
columns, and the Radtran facade (both constructors, files and in-memory
template) on the synthetic template."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clima_tpu.data import make_template_dir
from clima_tpu.config import load_settings as ref_load_settings, load_species as ref_load_species
from clima_tpu.radtran import Radtran as RefRadtran
from clima_tpu.radtran import data as ref_data
from clima_tpu.radtran.opacity import compute_opacity as ref_compute_opacity

from clima_tpu_torch import ClimaException
from clima_tpu_torch.data import make_template
from clima_tpu_torch.radtran import Radtran, compute_opacity, optical_data_from_numpy
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ = 12


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    t = make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=NZ, n_zenith=2)
    # a settings file naming its gases and particles, for from_settings
    t["settings_me"] = os.path.join(os.path.dirname(t["settings"]), "settings_me.yaml")
    with open(t["settings_me"], "w") as f:
        f.write("""\
planet:
  planet-mass: 5.972e27
  planet-radius: 6.371e8
  surface-albedo: 0.3
  number-of-zenith-angles: 2
optical-properties:
  species:
    gases: [H2O, CO2, O2, N2, CH4]
    particles: [HCaer]
  k-method: RandomOverlapResortRebin
  opacities: {k-distributions: true, CIA: true, rayleigh: true, photolysis-xs: true,
    water-continuum: MT_CKD, particle-xs: [{name: HCaer, data: khare1984}]}
""")
    return t


def column(gas_names, nz=NZ, T_surf=288.0):
    """The bench.py Earth-like prescribed column (ground-up)."""
    zc = np.linspace(0.0, 7.0e6, nz)
    T = np.maximum(T_surf - 6.5e-5 * zc, 200.0)
    dz = np.full(nz, 7.0e6 / nz)
    P = 1.013 * np.exp(-zc / 8.0e5)
    den = P * 1.0e6 / (1.380649e-16 * T)
    mix = np.full((nz, len(gas_names)), 1e-12)
    mix[:, gas_names.index("H2O")] = 1e-2 * np.exp(-zc / 2e5) + 1e-6
    mix[:, gas_names.index("CO2")] = 400e-6
    mix[:, gas_names.index("N2")] = 0.78
    return T, P, mix * den[:, None], dz


def _particles(nz=NZ):
    z = np.linspace(0.0, 1.0, nz)
    return (1e2 * np.exp(-((z - 0.6) / 0.1) ** 2))[:, None], np.full((nz, 1), 1e-5)


@pytest.fixture(scope="module")
def tables(template):
    s = ref_load_settings(template["settings_me"])
    op = ref_data.load_optical_data(template["datadir"], s.gases, s.particles, s.op)
    ir = ref_data.load_channel(template["datadir"], "ir", None, op)
    sol = ref_data.load_channel(template["datadir"], "solar", None, op)
    return s, op, optical_data_from_numpy(op, ir, sol, "cpu", torch.float64)[0]


def _aee(op):
    return dataclasses.replace(
        op, kset=dataclasses.replace(op.kset, k_method="AdaptiveEquivalentExtinction"))


@pytest.mark.parametrize("particles,k_method", [(False, "RORR"), (True, "RORR"), (False, "AEE")])
def test_compute_opacity_matches_reference(tables, particles, k_method):
    s, ref_op, op = tables
    if k_method == "AEE":
        ref_op, op = _aee(ref_op), _aee(op)
    T, P, dens, dz = column(s.gases)
    pden, radii = _particles() if particles else (None, None)
    ref = ref_compute_opacity(ref_op, *(jnp.asarray(x) for x in (P, T, dens, dz)),
                              *((jnp.asarray(pden), jnp.asarray(radii)) if particles else ()))
    t = lambda x: torch.tensor(x)[None]
    got = compute_opacity(op, t(P), t(T), t(dens), t(dz),
                          t(pden) if particles else None, t(radii) if particles else None)
    for k in ("tau", "w0", "g", "tau_band"):
        assert got[k].shape == (1,) + ref[k].shape, k
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(ref[k]), rtol=1e-12, err_msg=k)


def test_compute_opacity_batch_equals_single_columns(tables):
    s, _, op = tables
    cols = [column(s.gases, T_surf=Ts) for Ts in (280.0, 288.0, 296.0)]
    stack = lambda i: torch.tensor(np.stack([c[i] for c in cols]))
    batch = compute_opacity(op, stack(1), stack(0), stack(2), stack(3))
    for b, (T, P, dens, dz) in enumerate(cols):
        one = compute_opacity(op, *(torch.tensor(x)[None] for x in (P, T, dens, dz)))
        for k, v in one.items():
            np.testing.assert_allclose(batch[k][b].numpy(), v[0].numpy(), rtol=1e-13, err_msg=k)


def _assert_same_results(got, ref, rtol=1e-10):
    """Integrated fluxes and amean at rtol; per-bin arrays at rtol with an
    absolute floor 1e-12 below their peak (cancellation noise of values that
    small)."""
    for w in ("wrk_ir", "wrk_sol"):
        for f in ("fup_n", "fdn_n", "amean", "fup_a", "fdn_a", "tau_band"):
            want = getattr(getattr(ref, w), f)
            atol = 0.0 if f in ("fup_n", "fdn_n", "amean") else 1e-12 * np.abs(want).max()
            np.testing.assert_allclose(getattr(getattr(got, w), f), want, rtol=rtol, atol=atol,
                                       err_msg=f"{w}.{f}")
    np.testing.assert_allclose(got.f_total, ref.f_total, rtol=rtol, atol=1e-6)


def test_radtran_matches_reference(template):
    gases = ref_load_species(template["species"]).gas_names
    args = (gases, [], template["settings"], template["star"], 2, 0.25, NZ, template["datadir"])
    ref, got = RefRadtran(*args), Radtran(*args, device="cpu")
    col = column(gases)
    np.testing.assert_allclose(got.TOA_fluxes(290.0, *col), ref.TOA_fluxes(290.0, *col),
                               rtol=1e-10)
    _assert_same_results(got, ref)
    for m in (got, ref):
        m.apply_radiation_enhancement(1.5)
        m.set_bolometric_flux(1000.0)
    np.testing.assert_allclose(got.f_total, ref.f_total, rtol=1e-10, atol=1e-6)
    np.testing.assert_allclose(got.wrk_sol.fdn_n, ref.wrk_sol.fdn_n, rtol=1e-10)
    assert got.bolometric_flux() == pytest.approx(ref.bolometric_flux(), rel=1e-14)
    assert got.skin_temperature(0.3) == pytest.approx(ref.skin_temperature(0.3), rel=1e-14)
    assert got.equilibrium_temperature(0.3) == pytest.approx(
        ref.equilibrium_temperature(0.3), rel=1e-14)

    # opacity reuse without solar, then the in-memory template gives the same model
    np.testing.assert_allclose(
        got.TOA_fluxes(285.0, *col, compute_solar=False, compute_opacity=False)[1],
        ref.TOA_fluxes(285.0, *col, compute_solar=False, compute_opacity=False)[1], rtol=1e-10)
    mem = make_template(nz=NZ, n_zenith=2)
    in_mem = Radtran(gases, [], mem["settings"], mem["star"], 2, 0.25, NZ, mem["datadir"],
                     device="cpu")
    assert in_mem.TOA_fluxes(290.0, *col) == Radtran(*args, device="cpu").TOA_fluxes(290.0, *col)

    with pytest.raises(ClimaException):
        got.TOA_fluxes(290.0, col[0][:-1], *col[1:])


def test_from_settings_with_particles_matches_reference(template):
    kw = dict(num_zenith_angles=2, surface_albedo=0.15, nz=NZ, datadir=template["datadir"])
    ref = RefRadtran.from_settings(template["settings_me"], template["star"], **kw)
    got = Radtran.from_settings(template["settings_me"], template["star"], device="cpu", **kw)
    assert got.opacities2yaml() == ref.opacities2yaml()
    col = column(got.species_names)
    pden, radii = _particles()
    np.testing.assert_allclose(got.TOA_fluxes(288.0, *col, pden, radii),
                               ref.TOA_fluxes(288.0, *col, pden, radii), rtol=1e-10)
    _assert_same_results(got, ref)

    # custom optical properties injected into both
    wv = np.array([200.0, 1000.0, 1e4, 1e5])
    P = np.array([1.0e6, 1.0e4, 1.0e2])
    dtau = np.full((3, 4), 1e-7)
    for m in (ref, got):
        m.set_custom_optical_properties(wv, P, dtau, np.full((3, 4), 0.9), np.full((3, 4), 0.5))
    np.testing.assert_allclose(got.TOA_fluxes(288.0, *col, pden, radii),
                               ref.TOA_fluxes(288.0, *col, pden, radii), rtol=1e-10)
    with pytest.raises(ClimaException):
        got.TOA_fluxes(288.0, *col)  # particles but no pdensities/radii
    for m in (ref, got):
        m.unset_custom_optical_properties()
    np.testing.assert_allclose(got.TOA_fluxes(288.0, *col, pden, radii),
                               ref.TOA_fluxes(288.0, *col, pden, radii), rtol=1e-10)
