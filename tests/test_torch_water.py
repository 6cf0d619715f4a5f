"""The PyTorch port's H2O latent heats and saturation vapour pressures
(clima_tpu_torch.physics.water) against clima_tpu.physics.water (float64,
CPU), and its exponential integral against scipy's."""

import numpy as np
import pytest
import scipy.special
import torch

from clima_tpu.physics import water as ref_water

from clima_tpu_torch.physics import water

FUNCTIONS = ["latent_heat_H2O", "latent_heat_H2O_vap", "latent_heat_H2O_sub",
             "sat_pressure_H2O", "sat_pressure_H2O_vap", "sat_pressure_H2O_sub"]


def test_public_names_match_reference():
    assert sorted(water.__all__) == sorted(ref_water.__all__)
    for name in ("T_freeze", "mu_H2O", "Rgas"):
        assert getattr(water, name) == getattr(ref_water, name)


# The vapour-branch SVP sums -A*B*T*Ei(B*T) + A*exp(B*T) + C with terms of
# ~3.4e12 to ~1e10: a 1-ulp difference between two exp implementations grows
# ~5000-fold, and the exponent carries it into the pressure. Both packages
# are within 9.3e-13 of a 40-digit evaluation of the fit on this grid and
# differ by up to 1.25e-12 from each other (XLA's exp and torch's round
# differently); the other fits agree to 1e-13.
RTOL = {"sat_pressure_H2O": 2e-12, "sat_pressure_H2O_vap": 2e-12}


@pytest.mark.parametrize("name", FUNCTIONS)
def test_matches_reference_across_freezing(name):
    """150-600 K and a fine grid around T_freeze, where the piecewise fits
    switch branch, at rtol 1e-13 (the vapour-branch SVP at 2e-12, above)."""
    T = np.concatenate([np.linspace(150.0, 600.0, 451),
                        water.T_freeze + np.linspace(-1e-3, 1e-3, 21)])
    got = getattr(water, name)(torch.tensor(T))
    want = np.asarray(getattr(ref_water, name)(T))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL.get(name, 1e-13))


@pytest.mark.parametrize("T, svp, latent", [
    (300.0, 35183.75932293567, 24214868468.57129),  # tests/test_golden.py:62-64
    (250.0, 763.1852853300326, None),                 # tests/test_golden.py:67
])
def test_golden_values(T, svp, latent):
    """Python floats in give float64 tensors out, at the golden values."""
    np.testing.assert_allclose(float(water.sat_pressure_H2O(T)), svp, rtol=1e-13)
    if latent is not None:
        np.testing.assert_allclose(float(water.latent_heat_H2O(T)), latent, rtol=1e-13)


def test_expi_matches_scipy():
    """Ei on |x| <= 0.05 (both signs; the fits' B*T stay inside it below
    2400 K) and at the fits' own arguments, at 1e-14 relative."""
    x = np.concatenate([-np.geomspace(1e-8, 0.05, 200), np.geomspace(1e-8, 0.05, 200)])
    T = np.linspace(100.0, 2400.0, 50)
    x = np.concatenate([x, water.B_v * T, water.B_s * T])
    np.testing.assert_allclose(water.expi(torch.tensor(x)).numpy(), scipy.special.expi(x),
                               rtol=1e-14)
