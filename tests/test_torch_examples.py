"""The port's four examples (clima_tpu_torch.examples) on the CPU at small
depths, held to the JAX package where the example's numbers come from one
model call (float64).

- ``modern_earth_radtran`` at nz=8 (8 zenith angles, five gases, the HCaer
  haze): f_total, the TOA solar flux and the OLR, and f_total with the
  custom optical properties, against the JAX package's ``Radtran`` built
  from the same settings text (rtol 1e-10, f_total with atol 1e-6, as
  tests/test_torch_radtran.py); the spectra file and ``opacities2yaml``.
- ``tutorial_adiabat_climate`` at nz=4, 1 substep: ``TOA_fluxes`` against the
  JAX package's ``AdiabatClimate`` on the same template (rtol 1e-9, as
  tests/test_torch_adiabat.py); the RCE converges; the file
  ``out2atmosphere_txt`` wrote reads back through both packages'
  ``AtmosphereFile`` with the same labels and columns. (The JAX package's
  surface_temperature and RCE are held in tests/test_torch_adiabat.py and
  tests/test_torch_rce.py.)
- ``early_mars`` at nz=4, 1 substep (where all six columns converge): against
  the JAX package's ``batched_surface_temperature`` on the JAX example's
  Mars settings (the same iteration count and converged flags, the
  converged columns' T_surf at rtol 1e-7), its column model evaluated
  column by column by its jitted self through ``jax.pure_callback`` (as
  tests/test_torch_solvers.py: traced inline under the solver's loop it
  takes ~75 s); and each converged column's T_surf against the port's
  unbatched ``surface_temperature`` of that column (rtol 1e-6, the batched
  solver's own stopping test).
- ``climate_evolve`` at nz=4: the stream is read by both packages'
  ``load_evolve_file``, with the same fields and shapes.

Each example runs once per module; the JAX models are built (and jit
their programs) once per module.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.climate import load_evolve_file as ref_load_evolve_file
from clima_tpu.config.atmosphere_file import AtmosphereFile as RefAtmosphereFile
from clima_tpu.data import make_template_dir, write_settings_yaml
from clima_tpu.parallel import pipeline as ref_pipeline
from clima_tpu.radtran import Radtran as RefRadtran

from clima_tpu_torch.climate import load_evolve_file
from clima_tpu_torch.config.atmosphere_file import AtmosphereFile
from clima_tpu_torch.examples import (climate_evolve, early_mars, modern_earth_radtran,
                                      tutorial_adiabat_climate)
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ_RADTRAN, NZ_ADIABAT, NZ_CLIMATE = 8, 4, 4
SUBSTEPS = 1  # the adiabat examples' march, on both sides of each comparison


@pytest.fixture(scope="module")
def radtran_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("modern_earth")
    return modern_earth_radtran.main(device="cpu", nz=NZ_RADTRAN, root=str(root))


@pytest.fixture(scope="module")
def ref_radtran(tmp_path_factory):
    root = tmp_path_factory.mktemp("modern_earth_ref")
    t = make_template_dir(str(root), nz=NZ_RADTRAN, n_zenith=8, particles=True)
    settings = root / "settings_me.yaml"
    settings.write_text(modern_earth_radtran.settings_text(NZ_RADTRAN))
    return RefRadtran.from_settings(str(settings), t["star"], num_zenith_angles=8,
                                    surface_albedo=0.15, nz=NZ_RADTRAN, datadir=t["datadir"])


def test_modern_earth_radtran_matches_reference(radtran_run, ref_radtran):
    ref = ref_radtran
    T_surf, T, P, dens, dz, pden, radii = modern_earth_radtran.earth_column(NZ_RADTRAN)
    ref.radiate(T_surf, T, P, dens, dz, pdensities=pden, radii=radii)
    np.testing.assert_allclose(radtran_run["f_total"], np.asarray(ref.f_total), rtol=1e-10,
                               atol=1e-6)
    np.testing.assert_allclose(radtran_run["toa_solar_fdn"], float(ref.wrk_sol.fdn_n[-1]),
                               rtol=1e-10)
    np.testing.assert_allclose(radtran_run["olr"], float(ref.wrk_ir.fup_n[-1]), rtol=1e-10)
    assert radtran_run["f_total_restored"] == pytest.approx(radtran_run["f_total"][0],
                                                            rel=1e-6)

    # the example's custom optical properties, injected into the JAX model
    wv = np.linspace(float(ref.sol.wavl[0]), float(ref.ir.wavl[-1]), 4)
    ref.set_custom_optical_properties(wv, np.logspace(6.0, 0.0, 6), np.full((6, 4), 1e-8),
                                      np.full((6, 4), 0.5), np.full((6, 4), 0.3))
    try:
        ref.radiate(T_surf, T, P, dens, dz, pdensities=pden, radii=radii)
    finally:
        ref.unset_custom_optical_properties()
    np.testing.assert_allclose(radtran_run["f_total_custom"], float(ref.f_total[0]), rtol=1e-10,
                               atol=1e-6)


def test_modern_earth_radtran_writes_its_spectra_and_yaml(radtran_run, ref_radtran):
    assert radtran_run["opacities_yaml"] == ref_radtran.opacities2yaml()
    with np.load(radtran_run["spectra_file"]) as d:
        assert set(d.files) == {"sol_wavl", "ir_wavl", "fup_sol_toa", "fdn_sol_toa",
                                "fup_ir_toa"}
        assert d["fup_sol_toa"].shape == (len(d["sol_wavl"]) - 1,)
        assert d["fup_ir_toa"].shape == (len(d["ir_wavl"]) - 1,)
        assert all(np.isfinite(d[k]).all() for k in d.files)


@pytest.fixture(scope="module")
def tutorial_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tutorial")
    return tutorial_adiabat_climate.main(device="cpu", nz=NZ_ADIABAT, root=str(root),
                                         substeps=SUBSTEPS)


def test_tutorial_toa_fluxes_match_reference(tutorial_run, tmp_path):
    t = make_template_dir(str(tmp_path), nz=NZ_ADIABAT, n_zenith=1)
    ref = RefAdiabatClimate(t["species"], t["settings"], t["star"], t["datadir"],
                            substeps=SUBSTEPS)
    ref.verbose = False
    want = ref.TOA_fluxes(280.0, tutorial_adiabat_climate.earth_P_i(ref))
    np.testing.assert_allclose((tutorial_run["ISR"], tutorial_run["OLR"]), want, rtol=1e-9)


def test_tutorial_rce_converges_and_its_file_reads_back(tutorial_run):
    assert tutorial_run["converged"]
    assert 0 <= tutorial_run["convective_layers"] <= NZ_ADIABAT
    path = tutorial_run["atmosphere_file"]
    got, want = AtmosphereFile(path), RefAtmosphereFile(path)
    assert got.labels == want.labels
    assert got.labels[:5] == ["alt", "press", "den", "temp", "eddy"]
    for k in want.labels:
        np.testing.assert_array_equal(got.columns[k], want.columns[k])
    np.testing.assert_allclose(got.columns["temp"], tutorial_run["T"], rtol=1e-5)


@pytest.fixture(scope="module")
def mars_run():
    return early_mars.main(device="cpu", nz=NZ_ADIABAT, substeps=SUBSTEPS)


def batched_by_callback(ref):
    """The JAX package's column functions for ``ref``, whose damped-Newton
    step (its own code) evaluates ``toa_fluxes`` column by column by its
    jitted self behind ``jax.pure_callback``."""
    fns = dict(ref_pipeline.make_column_fns(ref))
    toa = jax.jit(fns["toa_fluxes"])
    ng = ref.sp.ng
    spec = (jax.ShapeDtypeStruct((), jnp.float64),) * 2  # (ISR, OLR) of a column

    def host(T_surf, P_i):
        lead = np.shape(T_surf)
        T_surf, P_i = np.ravel(T_surf), np.reshape(P_i, (-1, ng))
        rows = [toa(T_surf[i], P_i[i]) for i in range(T_surf.size)]
        return tuple(np.reshape([np.asarray(r[k]) for r in rows], lead) for k in range(2))

    toa_by_callback = lambda T_surf, P_i: jax.pure_callback(host, spec, T_surf, P_i,
                                                             vmap_method="broadcast_all")
    step = fns["newton_step"]
    cells = tuple(types.CellType(toa_by_callback) if name == "toa_fluxes" else cell
                  for name, cell in zip(step.__code__.co_freevars, step.__closure__))
    fns["newton_step"] = types.FunctionType(step.__code__, step.__globals__, step.__name__,
                                            step.__defaults__, cells)
    return fns


@pytest.fixture(scope="module")
def ref_mars_solve(tmp_path_factory):
    """The JAX example's sweep (examples/early_mars.py: its Mars settings and
    inventories) at nz=4, 1 substep."""
    root = tmp_path_factory.mktemp("mars_ref")
    t = make_template_dir(str(root), nz=NZ_ADIABAT, n_zenith=1)
    settings = str(root / "settings_mars.yaml")
    write_settings_yaml(settings, nz=NZ_ADIABAT, planet_mass=6.4169e26, planet_radius=3.3895e8,
                        surface_albedo=0.2, n_zenith=1, photon_scale_factor=0.4286 * 0.75)
    ref = RefAdiabatClimate(t["species"], settings, t["star"], t["datadir"], substeps=SUBSTEPS)
    ref.verbose = False
    P_i = np.full((6, ref.sp.ng), 1.0e-15)
    P_i[:, ref.species_names.index("H2O")] = 270.0e6
    P_i[:, ref.species_names.index("CO2")] = np.array([0.1, 0.3, 0.5, 1.0, 2.0, 3.0]) * 1.0e6
    fns = batched_by_callback(ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_pipeline, "make_column_fns", lambda c: fns)
        T, _, conv, iters = ref_pipeline.batched_surface_temperature(ref, P_i, T_guess=230.0)
    return np.asarray(T), np.asarray(conv), int(iters)


def test_early_mars_matches_reference(mars_run, ref_mars_solve):
    T_r, conv_r, iters_r = ref_mars_solve
    np.testing.assert_array_equal(mars_run["P_CO2_bars"], [0.1, 0.3, 0.5, 1.0, 2.0, 3.0])
    assert mars_run["iterations"] == iters_r
    np.testing.assert_array_equal(mars_run["converged"], conv_r)
    assert conv_r.all()
    np.testing.assert_allclose(mars_run["T_surf"][conv_r], T_r[conv_r], rtol=1e-7)


def test_early_mars_matches_unbatched_surface_temperature(mars_run):
    """rtol 1e-6: the batched damped Newton stops once |ISR - OLR| < 1e-6 ISR,
    which leaves T_surf up to ~3e-7 from the root (1.7e-7 measured on the
    2 bar column), where the unbatched hybrd solve stops at xtol 1.5e-8."""
    out = mars_run
    assert out["ranks"] == 1 and out["T_surf"].shape == early_mars.P_CO2_BARS.shape
    c = early_mars.mars_model(NZ_ADIABAT, "cpu", SUBSTEPS)
    P_i = early_mars.mars_P_i(c)
    assert out["converged"].all()
    for b in np.flatnonzero(out["converged"]):
        want = c.surface_temperature(P_i[b], T_guess=230.0)
        np.testing.assert_allclose(out["T_surf"][b], want, rtol=1e-6, err_msg=f"column {b}")


def test_climate_evolve_stream_reads_in_both_packages(tmp_path):
    out = climate_evolve.main(device="cpu", nz=NZ_CLIMATE, root=str(tmp_path))
    assert out["converged"]
    got, want = load_evolve_file(out["evolve_file"]), ref_load_evolve_file(out["evolve_file"])
    assert set(got) == set(want) and {"t", "T"} <= set(got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["T"].shape == (len(climate_evolve.T_EVAL), NZ_CLIMATE + 1)
    np.testing.assert_allclose(got["t"], climate_evolve.T_EVAL, rtol=1e-12)
    assert np.isfinite(got["T"]).all()
