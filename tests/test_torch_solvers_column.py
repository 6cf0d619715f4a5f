"""``batched_make_column`` (with and without an ocean, and with a poisoned
lane) and ``batched_make_profile_bg_gas`` of the PyTorch port against
clima_tpu.parallel.solvers (float64, CPU), on test_torch_pipeline.py's model
(nz=6, 2 zenith angles, substeps=2) at B=2: P_i_surf at rtol 1e-8 (both sides
take the same steps and the result carries the residuals' roundoff),
``converged`` and ``status`` equal. As in test_torch_solvers_surface.py, the
JAX package's solver programs run with their column model evaluated column
by column by its jitted self through ``jax.pure_callback``. (A file of its
own, so that the test workers run it beside test_torch_solvers.py.)
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.data import make_template_dir
from clima_tpu.parallel import solvers as ref_solvers

from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.parallel import (
    batched_make_column,
    batched_make_profile_bg_gas,
    make_column_fns,
)
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


B = 2
EPS64 = np.finfo(np.float64).eps


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    t = make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=6, n_zenith=2)
    files = (t["species"], t["settings"], t["star"], t["datadir"])
    ref = RefAdiabatClimate(*files, substeps=2)
    ref.verbose = False
    return ref, AdiabatClimate.from_reference(ref, *files, device="cpu")


@pytest.fixture(scope="module")
def column_fns_by_callback(models):
    """The JAX package's column functions, evaluated per column by their
    jitted selves behind ``jax.pure_callback`` (see the module docstring)."""
    ref, _ = models
    ng = ref.sp.ng
    fns = {}
    for name, fn in ref_solvers.make_column_fns(ref).items():
        if name not in ("profile_only", "column_model"):
            continue
        column = jax.jit(fn)
        spec = jax.eval_shape(column, 280.0, jnp.ones(ng), 180.0)

        def host(T_surf, P_i, T_trop, column=column, spec=spec):
            lead = np.shape(T_surf)
            T_surf, T_trop = np.broadcast_to(T_surf, lead).ravel(), np.broadcast_to(T_trop, lead).ravel()
            P_i = np.broadcast_to(P_i, lead + (ng,)).reshape(-1, ng)
            rows = [column(T_surf[i], P_i[i], T_trop[i]) for i in range(T_surf.size)]
            return {k: np.stack([np.asarray(r[k]) for r in rows]).reshape(lead + s.shape)
                    for k, s in spec.items()}

        fns[name] = lambda T_surf, P_i, T_trop, host=host, spec=spec: jax.pure_callback(
            host, spec, T_surf, P_i, T_trop, vmap_method="broadcast_all")
    return fns


@pytest.fixture
def reference(models, column_fns_by_callback, monkeypatch):
    """The JAX model with its solvers' column functions routed by callback."""
    monkeypatch.setattr(ref_solvers, "make_column_fns", lambda c: column_fns_by_callback)
    return models[0]


def p_batch(c):
    """H2O 270 bar, CO2 300..600, N2 1 bar."""
    P_i = np.full((B, c.sp.ng), 1.0e-15)
    P_i[:, c.species_names.index("H2O")] = 270.0e6
    P_i[:, c.species_names.index("CO2")] = np.linspace(300.0, 600.0, B)
    P_i[:, c.species_names.index("N2")] = 1.0e6
    return P_i


def n_targets(c, T_surf=280.0, factors=(1.0, 1.1)):
    """Column inventories N_atmos + N_surface of the port's host profile,
    scaled per lane."""
    c.make_profile(T_surf, p_batch(c)[0])
    return np.outer(factors, c.N_atmos + c.N_surface)


def assert_same_solve(got, want, keys, rtol=1e-8):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, err_msg=k)
    assert np.array_equal(got["converged"].numpy(), np.asarray(want["converged"]))
    assert np.array_equal(got["status"].numpy(), np.asarray(want["status"]))


# --- newton_solve on analytic residuals -----------------------------------


# --- the batched solves on the model ---------------------------------------


def ocean_laws(c_ref, c):
    """test_device_solvers.py's law: CO2 dissolves in the H2O ocean at
    1e-2 mol/kg per bar, per column in jnp and over a batch in torch."""
    iCO2, ng = c.species_names.index("CO2"), c.sp.ng

    def law_jnp(T_surf, P_i_bars):
        return jnp.zeros(ng).at[iCO2].set(1.0e-2 * P_i_bars[iCO2])

    def law_torch(T_surf, P_i_bars):
        m = torch.zeros_like(P_i_bars)
        m[:, iCO2] = 1.0e-2 * P_i_bars[:, iCO2]
        return m

    return {"H2O": law_jnp}, {"H2O": law_torch}


@pytest.mark.parametrize("ocean", [False, True], ids=["no_ocean", "ocean"])
def test_batched_make_column_matches_reference(models, reference, ocean):
    _, c = models
    N_b, T_b = n_targets(c), np.full(B, 280.0)
    laws = ocean_laws(reference, c) if ocean else (None, None)
    want = ref_solvers.batched_make_column(reference, T_b, N_b, ocean_fcns=laws[0])
    got = batched_make_column(c, T_b, N_b, ocean_fcns=laws[1])
    assert got["converged"].all()
    assert_same_solve(got, want, ["P_i_surf"])
    if ocean:  # the ocean term is live: part of the CO2 target is dissolved
        m = make_column_fns(c)["profile_only"](torch.tensor(T_b), got["P_i_surf"], c.T_trop)
        iCO2 = c.species_names.index("CO2")
        in_air = (m["N_atmos"] + m["N_surface"])[:, iCO2].numpy()
        assert (in_air < 0.99 * N_b[:, iCO2]).all()


def test_batched_make_column_poisoned_lane(models, reference):
    """A lane with a NaN target ends unconverged (status 3); the other lane
    is what it is alone at rtol 1e-9 (the model's reductions may round
    differently at another batch size)."""
    _, c = models
    N_b = n_targets(c)
    N_b[1] = np.nan
    got = batched_make_column(c, np.full(B, 280.0), N_b)
    alone = batched_make_column(c, torch.full((1,), 280.0), torch.tensor(N_b[:1]))  # tensors in
    assert not got["converged"][1] and int(got["status"][1]) == 3
    np.testing.assert_allclose(got["P_i_surf"][:1].numpy(), alone["P_i_surf"].numpy(), rtol=1e-9)
    # the norms at the root and their floor are roundoff: finite, at its level
    np.testing.assert_allclose(got["fnorm"][:1].numpy(), alone["fnorm"].numpy(), rtol=1e-9,
                               atol=16 * EPS64)
    assert 0.0 < float(got["fnorm_floor"][0]) < 1e-10
    for k in ("converged", "status"):
        assert torch.equal(got[k][:1], alone[k])


def test_batched_make_profile_bg_gas_matches_reference(models, reference):
    _, c = models
    args = (np.full(B, 280.0), p_batch(c), np.array([1.0e6, 2.0e6]), "N2")
    want = ref_solvers.batched_make_profile_bg_gas(reference, *args)
    got = batched_make_profile_bg_gas(c, *args)
    assert got["converged"].all()
    assert_same_solve(got, want, ["P_i_surf"])
