"""The batched surface-temperature solves of the PyTorch port against
clima_tpu.parallel.solvers (float64, CPU): ``batched_surface_temperature_trop``,
``_column`` and ``_bg_gas`` on test_torch_solvers.py's model (nz=6, 2 zenith
angles, substeps=2) at B=2 against the JAX package's: T_surf, T_trop and
P_i_surf at rtol 1e-8, ``converged`` and ``status`` equal. As there, the JAX
package's solver programs run with their column model evaluated column by
column by its jitted self through ``jax.pure_callback``. (A file of its own,
so that the test workers run it beside test_torch_solvers.py.)
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
    batched_surface_temperature_bg_gas,
    batched_surface_temperature_column,
    batched_surface_temperature_trop,
)
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


B = 2


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


# --- the batched surface-temperature solves ------------------------------


def test_batched_surface_temperature_trop_matches_reference(models, reference):
    _, c = models
    want = ref_solvers.batched_surface_temperature_trop(reference, p_batch(c), T_guess=260.0)
    got = batched_surface_temperature_trop(c, p_batch(c), T_guess=260.0)
    assert got["converged"].all()
    assert_same_solve(got, want, ["T_surf", "T_trop"])


def test_batched_surface_temperature_column_matches_reference(models, reference):
    _, c = models
    N_b = n_targets(c, T_surf=259.0, factors=(1.0, 1.05))
    want = ref_solvers.batched_surface_temperature_column(reference, N_b, T_guess=259.0)
    got = batched_surface_temperature_column(c, N_b, T_guess=259.0)
    assert got["converged"].all()
    assert_same_solve(got, want, ["T_surf", "P_i_surf"])


def test_batched_surface_temperature_bg_gas_matches_reference(models, reference):
    _, c = models
    args = (p_batch(c), np.array([1.0e6, 2.0e6]), "N2")
    want = ref_solvers.batched_surface_temperature_bg_gas(reference, *args, T_guess=260.0)
    got = batched_surface_temperature_bg_gas(c, *args, T_guess=260.0)
    assert got["converged"].all()
    assert_same_solve(got, want, ["T_surf", "P_i_surf"])
