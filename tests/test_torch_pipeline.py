"""Batched column pipelines of the PyTorch port against clima_tpu.parallel
(float64, CPU): make_column_fns' column model over a batch of three columns
against the JAX package's vmapped per-column functions (rtol 1e-9), and the
batched damped-Newton surface-temperature solve (rtol 1e-8: every lane takes
the same steps as the JAX lanes, and the result is the last iterate, which
carries the residuals' roundoff through at most max_iter steps)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.data import make_template_dir
from clima_tpu.parallel import (batched_surface_temperature as ref_batched_surface_temperature,
                                batched_toa_fluxes as ref_batched_toa_fluxes,
                                make_column_fns as ref_make_column_fns)

from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.parallel import (batched_surface_temperature, batched_toa_fluxes,
                                      make_column_fns)

B = 3


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    t = make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=6, n_zenith=2)
    files = (t["species"], t["settings"], t["star"], t["datadir"])
    ref = RefAdiabatClimate(*files, substeps=2)
    ref.verbose = False
    return ref, AdiabatClimate.from_reference(ref, *files, device="cpu")


def p_batch(c):
    """__graft_entry__._p_batch: H2O 270 bar, CO2 200..800, N2 1 bar."""
    P_i = np.full((B, c.sp.ng), 1.0e-15)
    P_i[:, c.species_names.index("H2O")] = 270.0e6
    P_i[:, c.species_names.index("CO2")] = np.linspace(200.0, 800.0, B)
    P_i[:, c.species_names.index("N2")] = 1.0e6
    return P_i


def test_batched_toa_fluxes_matches_reference(models):
    ref, c = models
    T_surf, P_i = np.linspace(270.0, 300.0, B), p_batch(c)
    got = batched_toa_fluxes(c, T_surf, P_i)
    want = ref_batched_toa_fluxes(ref, T_surf, P_i)
    for g, w in zip(got, want):
        assert g.shape == (B,) and g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9)


def test_column_model_and_profile_only_match_reference(models):
    """Every output of column_model (T_trop per column); profile_only gives
    the same reservoirs without the radiative transfer."""
    ref, c = models
    T_surf, P_i, T_trop = np.linspace(275.0, 295.0, B), p_batch(c), np.array([170.0, 180.0, 190.0])
    t = lambda x: torch.tensor(x)
    fns = make_column_fns(c)
    got = fns["column_model"](t(T_surf), t(P_i), t(T_trop))
    want = jax.jit(jax.vmap(ref_make_column_fns(ref)["column_model"]))(
        jnp.asarray(T_surf), jnp.asarray(P_i), jnp.asarray(T_trop))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9, atol=1e-300,
                                   err_msg=k)
    only = fns["profile_only"](t(T_surf), t(P_i), t(T_trop))
    assert set(only) == {"P_surf", "N_atmos", "N_surface", "f_i_surf"}
    for k, v in only.items():
        assert torch.equal(v, got[k]), k


def test_batched_surface_temperature_matches_reference(models):
    ref, c = models
    P_i = p_batch(c)
    T, resid, conv, iters = batched_surface_temperature(c, P_i, T_guess=280.0, max_iter=8)
    T_r, resid_r, conv_r, iters_r = ref_batched_surface_temperature(ref, P_i, T_guess=280.0,
                                                                    max_iter=8)
    assert iters == int(iters_r)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_r))
    np.testing.assert_allclose(T.numpy(), np.asarray(T_r), rtol=1e-8)
    np.testing.assert_allclose(resid.numpy(), np.asarray(resid_r), rtol=1e-6, atol=1e-6)
    assert conv.all()
