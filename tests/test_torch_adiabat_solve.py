"""The solves of the PyTorch port's AdiabatClimate against clima_tpu's
(float64, CPU), on test_torch_adiabat.py's template and models (nz=8, 2
zenith angles, substeps 2; AdiabatClimate.from_reference): surface_temperature,
with and without solving for T_trop, and make_column, at rtol 1e-6 (MINPACK
hybrd roots whose iterates stop once a step is below xtol = 1.49e-8 relative
in the log10 unknowns, so two residual functions that differ by roundoff may
stop one iteration apart, ~1e-7 relative); the input checks, and the entry
points' default device. (A file of its own, so that the test workers run it
beside test_torch_adiabat.py.)
"""

import numpy as np
import pytest
import torch

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.data import make_template_dir

from clima_tpu_torch import ClimaException, Radtran
from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.config import load_settings
from clima_tpu_torch.radtran import load_optical_data
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, SUBSTEPS = 8, 2
RTOL, RTOL_SOLVE = 1e-9, 1e-6
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


def test_surface_temperature_matches_reference(models):
    ref, c = models
    P_i = earth_like_P_i(c)
    T = c.surface_temperature(P_i, T_guess=280.0)
    assert T == pytest.approx(ref.surface_temperature(P_i, T_guess=280.0), rel=RTOL_SOLVE)
    ISR, OLR = c.TOA_fluxes(T, P_i)
    np.testing.assert_allclose(ISR, OLR, rtol=1e-5)


def test_surface_temperature_solving_for_T_trop_matches_reference(models):
    """The two-unknown solve (T_surf, T_trop) of a tidally locked dayside."""
    ref, c = models
    P_i = earth_like_P_i(c)
    try:
        for m in (ref, c):
            m.solve_for_T_trop = True
            m.tidally_locked_dayside = True
        T = c.surface_temperature(P_i, T_guess=280.0)
        assert T == pytest.approx(ref.surface_temperature(P_i, T_guess=280.0), rel=RTOL_SOLVE)
        assert c.T_trop == pytest.approx(ref.T_trop, rel=RTOL_SOLVE)
    finally:
        for m in (ref, c):
            m.solve_for_T_trop = False
            m.tidally_locked_dayside = False
            m.T_trop = 180.0


def test_make_column_matches_reference(models):
    ref, c = models
    N_i = np.full(c.sp.ng, 1.0e-10)
    N_i[c.species_names.index("H2O")] = 15.0e3  # mol/cm2
    N_i[c.species_names.index("CO2")] = 1.0
    N_i[c.species_names.index("N2")] = 36.0e2
    for m in (ref, c):
        m.make_column(280.0, N_i)
    _same_state(c, ref, rtol=RTOL_SOLVE)
    np.testing.assert_allclose(c.make_column_P_guess, ref.make_column_P_guess, rtol=RTOL_SOLVE)
    i = c.species_names.index("H2O")
    assert c.N_atmos[i] + c.N_surface[i] == pytest.approx(N_i[i], rel=1e-6)


def test_input_validation(models):
    _, c = models
    with pytest.raises(ClimaException):
        c.make_profile(100.0, earth_like_P_i(c))  # T_surf < T_trop
    with pytest.raises(ClimaException):
        c.make_profile(280.0, np.ones(2))
    with pytest.raises(ClimaException):
        c.make_profile_bg_gas(280.0, earth_like_P_i(c), 1e6, "XYZ")
    with pytest.raises(ClimaException):
        c.substeps = 0


def test_entry_points_default_to_the_card(template, monkeypatch):
    """With no device named, the port runs on the CUDA card, and without one it
    raises rather than picking the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdiabatClimate(*_files(template))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Radtran(["H2O", "N2"], [], template["settings"], template["star"], 2, 0.25, 10,
                template["datadir"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_optical_data(template["datadir"], ["H2O", "CO2", "N2"], [],
                          load_settings(template["settings"]).op)
