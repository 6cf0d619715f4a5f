"""Radiative-convective equilibrium of the PyTorch port against clima_tpu's
(float64, CPU).

One synthetic template (nz=8, 1 zenith angle, surface albedo 0.3, substeps
2); the port's model gets the JAX model's opacity tables and free parameters
(AdiabatClimate.from_reference).

make_profile_rc on the five convection masks of tests/test_rc_oracle.py and
with custom mixing ratios: the profile state at rtol 1e-9.

The objective, its batched Jacobian and the input errors are in
test_torch_rce_objective.py, the full RCE under two solve strategies in
test_torch_rce_solve.py (files of their own, so that the test workers run
them side by side).
"""

import numpy as np
import pytest
import torch

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.adiabat import rce as ref_rce
from clima_tpu.data import make_template_dir

from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.adiabat import rce
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, SUBSTEPS = 8, 2
RTOL = 1e-9
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


