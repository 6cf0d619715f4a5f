"""AdiabatClimate of the PyTorch port against clima_tpu's (float64, CPU).

Both models are built from one synthetic template; the port's gets the JAX
model's opacity tables and free parameters (AdiabatClimate.from_reference).
TOA fluxes (with callbacks and particles, and of a dry profile), the state
they leave behind and make_profile_bg_gas match at rtol 1e-9. The solves
(surface_temperature, make_column) are in test_torch_adiabat_solve.py (a
file of its own, so that the test workers run it beside this one). The
guards reproduced from the reference (ROADMAP Queue 3) are not asserted
here.
"""

import numpy as np
import pytest
import torch

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.data import make_template_dir

from clima_tpu_torch import ClimaException
from clima_tpu_torch.adiabat import AdiabatClimate
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, SUBSTEPS = 8, 2
RTOL = 1e-9
STATE = ("P", "T", "z", "dz", "gravity", "f_i", "densities", "N_atmos", "N_surface",
         "N_ocean", "lapse_rate", "f_i_surf")


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    return make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=NZ, n_zenith=2)


def _files(t):
    return t["species"], t["settings"], t["star"], t["datadir"]


@pytest.fixture(scope="module")
def models(template):
    ref = RefAdiabatClimate(*_files(template), substeps=SUBSTEPS)
    ref.verbose = False
    return ref, AdiabatClimate.from_reference(ref, *_files(template), device="cpu")


def earth_like_P_i(c, P_H2O=270.0e6, P_CO2=400.0, P_N2=1.0e6):
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = P_H2O
    P_i[c.species_names.index("CO2")] = P_CO2
    P_i[c.species_names.index("N2")] = P_N2
    return P_i


def _same_state(got, ref, rtol=RTOL, names=STATE):
    for k in names:
        np.testing.assert_allclose(getattr(got, k), getattr(ref, k), rtol=rtol, atol=1e-300,
                                   err_msg=k)
    assert got.P_trop == pytest.approx(ref.P_trop, rel=rtol)
    assert got.P_surf == pytest.approx(ref.P_surf, rel=rtol)


def test_toa_fluxes_matches_reference(models):
    ref, c = models
    P_i = earth_like_P_i(c)
    np.testing.assert_allclose(c.TOA_fluxes(280.0, P_i), ref.TOA_fluxes(280.0, P_i), rtol=RTOL)
    _same_state(c, ref)
    np.testing.assert_array_equal(c.convecting_with_below, ref.convecting_with_below)
    np.testing.assert_allclose(c.rad.f_total, ref.rad.f_total, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(c.heat_redistribution_parameters(),
                               ref.heat_redistribution_parameters(), rtol=RTOL)


def test_toa_fluxes_with_callbacks_and_particles_match_reference(models):
    """An ocean solubility callback, an albedo function and the reference
    pressure anchoring, set on both models."""
    ref, c = models

    def ocean_fcn(T_surf, ng, P_i_bars, args):
        m = np.zeros(ng)
        m[c.species_names.index("CO2")] = 1.0e-2 * P_i_bars[c.species_names.index("CO2")]
        return m

    P_i = earth_like_P_i(c, P_CO2=5.0e4)
    try:
        for m in (ref, c):
            m.set_ocean_solubility_fcn("H2O", ocean_fcn)
            m.albedo_fcn = lambda T: 0.3 + 1e-4 * (T - 280.0)
            m.reference_pressure = 1.0e5
        np.testing.assert_allclose(c.TOA_fluxes(285.0, P_i), ref.TOA_fluxes(285.0, P_i),
                                   rtol=RTOL)
        _same_state(c, ref)
        assert c.N_ocean[c.species_names.index("CO2"), c.species_names.index("H2O")] > 0
    finally:
        for m in (ref, c):
            m.ocean_fcns = [None] * m.sp.ng
            m.albedo_fcn = None
            m.reference_pressure = -1.0
            m.rad.surface_albedo = np.full(m.rad.sol.nw, 0.25)


def test_toa_fluxes_dry_and_output_utilities_match_reference(models, tmp_path):
    ref, c = models
    P_i = earth_like_P_i(c)
    c.make_profile(280.0, P_i)
    P = np.concatenate([[c.P_surf], c.P])
    T = np.concatenate([[c.T_surf], c.T])
    f_i = np.concatenate([[c.f_i_surf], c.f_i], axis=0)
    np.testing.assert_allclose(c.TOA_fluxes_dry(P, T, f_i), ref.TOA_fluxes_dry(P, T, f_i),
                               rtol=RTOL)
    _same_state(c, ref, names=STATE + ("lapse_rate_intended",))

    for m, name in ((ref, "ref.txt"), (c, "port.txt")):
        m.make_profile(280.0, P_i)
        m.out2atmosphere_txt(str(tmp_path / name), np.full(m.nz, 1e5), overwrite=True)
    _same_state(c, ref, names=("P", "T", "z", "dz", "f_i", "densities"))
    got, want = (open(tmp_path / n).readlines() for n in ("port.txt", "ref.txt"))
    assert got[0] == want[0]
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port.txt", skiprows=1),
                               np.loadtxt(tmp_path / "ref.txt", skiprows=1), rtol=1e-5)
    with pytest.raises(ClimaException):
        c.out2atmosphere_txt(str(tmp_path / "port.txt"), np.zeros(c.nz))


def test_make_profile_bg_gas_matches_reference(models):
    ref, c = models
    P_i = earth_like_P_i(c, P_H2O=1.0e4, P_CO2=400.0, P_N2=1.0)
    for m in (ref, c):
        m.make_profile_bg_gas(280.0, P_i, 1.0e6, "N2")
    _same_state(c, ref)
    assert c.P_surf == pytest.approx(1.0e6, rel=1e-6)


