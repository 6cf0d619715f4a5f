"""Radiative-convective equilibrium of the PyTorch port against clima_tpu's
(float64, CPU).

One synthetic template (nz=8, 1 zenith angle, surface albedo 0.3, substeps
2); the port's model gets the JAX model's opacity tables and free parameters
(AdiabatClimate.from_reference).

- make_profile_rc on the five convection masks of tests/test_rc_oracle.py
  and with custom mixing ratios, the objective and the batched
  finite-difference Jacobian: rtol 1e-9 (the Jacobian at tests/test_rce.py's
  rtol 1e-8 / atol 1e-12), and the port's batched Jacobian against its own
  serial one.
- The full RCE from surface_temperature's warm start under two solve
  strategies: the same convergence and final mask, T_surf and T at rtol
  1e-6. HYBRJ stops once its step is below xtol_rc = 1e-5 relative, so two
  residual functions that differ by roundoff may stop one iteration apart;
  1e-6 is the limit tests/test_torch_adiabat.py gives its solves for the
  same reason.
"""

import numpy as np
import pytest

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.adiabat import RCE_SOLVE_PTC_THEN_HYBRJ as REF_PTC_THEN_HYBRJ
from clima_tpu.adiabat import rce as ref_rce
from clima_tpu.data import make_template_dir
from clima_tpu.utils.errors import ClimaException as RefClimaException

from clima_tpu_torch import RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ, RCE_SOLVE_PTC_THEN_HYBRJ
from clima_tpu_torch import ClimaException
from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.adiabat import rce

NZ, SUBSTEPS = 8, 2
RTOL, RTOL_SOLVE = 1e-9, 1e-6
PROFILE_STATE = ("P", "T", "z", "dz", "f_i", "densities", "N_atmos", "N_surface", "lapse_rate",
                 "lapse_rate_intended", "f_i_surf")

# tests/test_rc_oracle.py's masks, as functions of nz
MASKS = {
    "all_radiative": lambda nz: np.zeros(nz, bool),
    "ground_zone": lambda nz: np.arange(nz) < 5,
    "mid_zone": lambda nz: (np.arange(nz) >= 4) & (np.arange(nz) < 9),
    "two_zones": lambda nz: (np.arange(nz) < 3) | ((np.arange(nz) >= 7) & (np.arange(nz) < 11)),
    "all_convective": lambda nz: np.ones(nz, bool),
}


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    return make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=NZ, n_zenith=1,
                             surface_albedo=0.3)


def _files(t):
    return t["species"], t["settings"], t["star"], t["datadir"]


@pytest.fixture(scope="module")
def models(template):
    ref = RefAdiabatClimate(*_files(template), substeps=SUBSTEPS)
    ref.verbose = False
    return ref, AdiabatClimate.from_reference(ref, *_files(template), device="cpu")


def earth_like_P_i(c):
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0
    P_i[c.species_names.index("N2")] = 1.0e6
    return P_i


def _same(got, ref, names, rtol=RTOL):
    for k in names:
        np.testing.assert_allclose(getattr(got, k), getattr(ref, k), rtol=rtol, atol=1e-300,
                                   err_msg=k)
    assert got.P_surf == pytest.approx(ref.P_surf, rel=rtol)


def _set_mask(models, mask):
    for m in models:
        m._set_convecting_zones(mask)
    ref, c = models
    for k in ("convecting_with_below", "_inds_Tx", "_ind_conv_lower", "_ind_conv_upper",
              "_ind_conv_lower_x"):
        np.testing.assert_array_equal(getattr(c, k), getattr(ref, k), err_msg=k)
    assert c.n_convecting_zones == ref.n_convecting_zones


@pytest.mark.parametrize("mask_name", sorted(MASKS) + ["custom_mix"])
def test_make_profile_rc_matches_reference(models, mask_name):
    """tests/test_rc_oracle.py's column (H2O condensing at the surface, a
    radiative T profile that cold-traps aloft), and the ground zone with
    CH4 and N2 at prescribed mixing ratios (tests/test_rce.py's custom case)."""
    ref, c = models
    P_i = np.full(c.sp.ng, 1.0)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0e3
    P_i[c.species_names.index("N2")] = 1.0e6
    T_in = np.concatenate([[285.0], np.maximum(np.linspace(280.0, 175.0, NZ), 175.0)])
    custom = mask_name == "custom_mix"
    _set_mask(models, MASKS["ground_zone" if custom else mask_name](NZ))
    try:
        for m, module in ((ref, ref_rce), (c, rce)):
            if custom:
                mix = np.zeros((20, 2))
                mix[:, 0], mix[:, 1] = 1.8e-6, 1.0 - 1.8e-6
                module._initialize_custom_inputs(m, ["CH4", "N2"], np.geomspace(2.0e6, 1.0, 20),
                                                 mix)
            m.make_profile_rc(P_i, T_in)
        _same(c, ref, PROFILE_STATE)
        np.testing.assert_array_equal(c.convecting_with_below, ref.convecting_with_below)
        if custom:
            assert np.all(c.f_i[:, c.species_names.index("CH4")] > 0)
    finally:
        for m, module in ((ref, ref_rce), (c, rce)):
            module._initialize_custom_inputs(m, None, None, None)


def _two_zone_state(models):
    """Both models at a two-zone mask and a linear T, and the DOF vector x."""
    _set_mask(models, MASKS["two_zones"](NZ))
    T_lin = np.linspace(280.0, 200.0, NZ + 1)
    for m in models:
        m.T_surf, m.T = T_lin[0], T_lin[1:].copy()
    return np.array([T_lin[ind - 1] for ind in models[1]._inds_Tx])


def test_objective_and_batched_jacobian_match_reference(models):
    ref, c = models
    P_i = earth_like_P_i(c)
    x = _two_zone_state(models)
    got = rce._objective(c, P_i, x)
    want = ref_rce._objective(ref, P_i, x)
    _same(c, ref, PROFILE_STATE)
    f_total = rce._f_total_edges_precise(c)
    np.testing.assert_allclose(f_total, ref_rce._f_total_edges_precise(ref), rtol=RTOL)
    # the residuals are differences of those net fluxes (dFdt) and their
    # quotients by heat capacities (dTdt): where they cancel to a small
    # value they keep the fluxes' absolute error, ~1e-13 of the flux scale
    scale = np.max(np.abs(f_total))
    for g, w, unit in zip(got, want, (1.0, np.max(np.abs(want[1] / want[0])))):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-12 * scale * unit)
    jac = rce._jacobian_from_base(c, x, got[1])
    np.testing.assert_allclose(jac, ref_rce._jacobian_from_base(ref, x, want[1]), rtol=1e-8,
                               atol=1e-12)
    # the Jacobian leaves the model's state as it found it
    _same(c, ref, ("T", "densities"))


def test_batched_jacobian_matches_serial(models):
    """The batched IR Jacobian equals the serial fixed-profile path (the
    port's own, as tests/test_rce.py holds the JAX package's)."""
    _, c = models
    P_i = earth_like_P_i(c)
    x = _two_zone_state(models)
    _, dTdt = rce._objective(c, P_i, x)
    jac_batched = rce._jacobian_from_base(c, x, dTdt)
    T_base, T_perts, deltas = rce._perturbation_matrix(c, x)
    jac_serial = np.empty_like(jac_batched)
    for i in range(len(x)):
        _, dTdt_p = rce._objective_fixed_profile(c, T_perts[i], False, False)
        jac_serial[:, i] = (dTdt_p - dTdt) / deltas[i]
    np.testing.assert_allclose(jac_batched, jac_serial, rtol=1e-8, atol=1e-12)


@pytest.fixture(scope="module")
def warm_start(models):
    """surface_temperature's solution on both models (the RCE seed)."""
    ref, c = models
    P_i = earth_like_P_i(c)
    T_surf = c.surface_temperature(P_i, T_guess=280.0)
    assert T_surf == pytest.approx(ref.surface_temperature(P_i, T_guess=280.0), rel=RTOL_SOLVE)
    return P_i, T_surf, c.T.copy()


@pytest.mark.parametrize("strategy", ["default", "ptc_then_hybrj"])
def test_rce_matches_reference(models, warm_start, strategy):
    ref, c = models
    P_i, T_surf, T_guess = warm_start
    if strategy == "ptc_then_hybrj":
        assert RCE_SOLVE_PTC_THEN_HYBRJ == REF_PTC_THEN_HYBRJ
        ref.rce_solve_strategy = c.rce_solve_strategy = RCE_SOLVE_PTC_THEN_HYBRJ
    try:
        converged = c.RCE(P_i, T_surf, T_guess)
        assert converged == ref.RCE(P_i, T_surf, T_guess)
    finally:
        ref.rce_solve_strategy = c.rce_solve_strategy = RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ
    assert converged
    np.testing.assert_array_equal(c.convecting_with_below, ref.convecting_with_below)
    assert c.T_surf == pytest.approx(ref.T_surf, rel=RTOL_SOLVE)
    np.testing.assert_allclose(c.T, ref.T, rtol=RTOL_SOLVE)
    # energy balance at the solution, as tests/test_rce.py checks it
    x = np.array([c.T_surf] + [c.T[ind - 2] for ind in c._inds_Tx[1:]])
    dFdt, _ = rce._objective(c, P_i, x)
    assert rce._flux_metrics(c, dFdt)[1] < 10 * c.xtol_rc


def test_rce_input_errors(template, models):
    """A T_guess of the wrong shape and a model without the doubled radiative
    grid raise, in the port as in the JAX package."""
    ref, c = models
    P_i = earth_like_P_i(c)
    single = (RefAdiabatClimate(*_files(template), double_radiative_grid=False),
              AdiabatClimate(*_files(template), double_radiative_grid=False, device="cpu"))
    for m, error in ((ref, RefClimaException), (c, ClimaException)):
        with pytest.raises(error, match="T_guess"):
            m.RCE(P_i, 280.0, np.full(NZ + 1, 250.0))
    for m, error in zip(single, (RefClimaException, ClimaException)):
        with pytest.raises(error, match="double_radiative_grid"):
            m.RCE(P_i, 280.0, np.full(NZ, 250.0))
