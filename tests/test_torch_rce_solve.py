"""The full radiative-convective equilibrium of the PyTorch port against
clima_tpu's (float64, CPU), on test_torch_rce.py's template and models
(nz=8, 1 zenith angle, surface albedo 0.3, substeps 2;
AdiabatClimate.from_reference).

From surface_temperature's warm start, under two solve strategies: the same
convergence and final mask, T_surf and T at rtol 1e-6. HYBRJ stops once its
step is below xtol_rc = 1e-5 relative, so two residual functions that differ
by roundoff may stop one iteration apart; 1e-6 is the limit
tests/test_torch_adiabat.py gives its solves for the same reason.
"""

import numpy as np
import pytest
import torch

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.adiabat import RCE_SOLVE_PTC_THEN_HYBRJ as REF_PTC_THEN_HYBRJ
from clima_tpu.data import make_template_dir

from clima_tpu_torch import RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ, RCE_SOLVE_PTC_THEN_HYBRJ
from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.adiabat import rce
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, SUBSTEPS = 8, 2
RTOL_SOLVE = 1e-6


def _files(t):
    return t["species"], t["settings"], t["star"], t["datadir"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    t = make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=NZ, n_zenith=1,
                          surface_albedo=0.3)
    ref = RefAdiabatClimate(*_files(t), substeps=SUBSTEPS)
    ref.verbose = False
    return ref, AdiabatClimate.from_reference(ref, *_files(t), device="cpu")


def earth_like_P_i(c):
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0
    P_i[c.species_names.index("N2")] = 1.0e6
    return P_i


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
