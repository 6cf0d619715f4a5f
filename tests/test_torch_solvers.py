"""Batched column solvers of the PyTorch port against clima_tpu.parallel.solvers
(float64, CPU).

``newton_solve`` is held against the JAX one on analytic residuals: the
NaN-poisoned quadratic of ``test_device_solvers.py``, a residual whose FD
Jacobian is singular at a lane's first guess, a poisoned lane beside healthy
ones, and the float32 precision-floor case. The five ``batched_*`` solves run
on ``test_torch_pipeline.py``'s model (nz=6, 2 zenith angles, substeps=2) at
B=2 against the JAX package's: P_i_surf, T_surf and T_trop at rtol 1e-8 (both
sides take the same steps and the result carries the residuals' roundoff),
``converged`` and ``status`` equal.

On the JAX side each solve is the JAX package's own program (ladders, residual
assembly, ``newton_solve`` under ``vmap``) with one change: its column model
(``make_column_fns(c)["profile_only"]`` or ``["column_model"]``) is evaluated
column by column by the JAX package's jitted per-column function through
``jax.pure_callback``. Tracing the model inline under the solver's nested
``vmap`` costs 60-160 s a solve on the CPU; the callback leaves the solver's
trace small and compiles the model once for the module.
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
    batched_surface_temperature_bg_gas,
    batched_surface_temperature_column,
    batched_surface_temperature_trop,
    make_column_fns,
    newton_solve,
)

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


def quadratic_jnp(x):
    r = jnp.stack([x[0] ** 2 + x[1] - 3.0, x[0] - x[1] ** 2 + 1.0])
    return jnp.where(x[0] > 10.0, jnp.nan, r), jnp.ones(2)


def quadratic_torch(X):
    r = torch.stack([X[:, 0] ** 2 + X[:, 1] - 3.0, X[:, 0] - X[:, 1] ** 2 + 1.0], dim=1)
    return torch.where(X[:, :1] > 10.0, torch.nan, r), torch.ones_like(r)


def singular_jnp(x):
    """d r0 / dx is 0 at x0 = 0: the FD Jacobian's first row vanishes there."""
    return jnp.stack([x[0] ** 2 - 1.0, x[1] - 2.0 + 0.1 * x[0]]), jnp.ones(2)


def singular_torch(X):
    r = torch.stack([X[:, 0] ** 2 - 1.0, X[:, 1] - 2.0 + 0.1 * X[:, 0]], dim=1)
    return r, torch.ones_like(r)


CASES = {
    # lane 0's first guess lies in the poisoned half-plane x0 > 10
    "nan_poisoned": (quadratic_jnp, quadratic_torch,
                     [[[20.0, 0.0], [1.0, 1.0]], [[1.5, 0.5], [3.0, 3.0]],
                      [[-2.0, 2.0], [0.3, 1.2]]]),
    # lane 0 starts where J is singular: two line fails, then its second guess
    "singular_jacobian": (singular_jnp, singular_torch,
                          [[[0.0, 0.0], [2.0, 1.0]], [[0.5, 0.0], [0.0, 1.0]],
                           [[-3.0, 5.0], [0.0, 0.0]]]),
}


def ref_newton(residual, ladder, **kw):
    out = jax.vmap(lambda l: ref_solvers.newton_solve(residual, l, **kw))(jnp.asarray(ladder))
    return [np.asarray(v) for v in out]


def port_newton(residual, ladder, **kw):
    return [v.numpy() for v in newton_solve(residual, torch.tensor(ladder), **kw)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_newton_solve_matches_reference(case):
    """Converged lanes: x at rtol 1e-12; fnorm at rtol 1e-12 beside an atol
    of 16 ulp of 1, the roundoff of the residuals' O(1) terms, which is all a
    norm at a root holds (the two sides' LU solves round differently).
    After one capped iteration, far from the roots, x and fnorm at rtol
    1e-12 alone."""
    res_jnp, res_torch, ladder = CASES[case]
    ladder = np.array(ladder)
    want = ref_newton(res_jnp, ladder, tol=1e-12)
    got = port_newton(res_torch, ladder, tol=1e-12)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=16 * EPS64)
    assert np.array_equal(got[2], want[2]) and got[2].all()
    assert np.array_equal(got[4], want[4])

    want = ref_newton(res_jnp, ladder[:, 1:], tol=1e-12, max_iter=1)
    got = port_newton(res_torch, ladder[:, 1:], tol=1e-12, max_iter=1)
    assert (want[1] > 1e-3).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[4], want[4])


def test_newton_solve_singular_jacobian_is_a_line_fail():
    """With only the singular guess, the lane stops after max_line_fails
    rejected steps where it started, on both sides."""
    ladder = np.array([[[0.0, 0.0]]])
    want = ref_newton(singular_jnp, ladder, tol=1e-12)
    got = port_newton(singular_torch, ladder, tol=1e-12)
    np.testing.assert_array_equal(got[0], ladder[:, 0])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    assert not got[2].any() and not want[2].any()
    assert np.array_equal(got[4], want[4])


def test_newton_solve_poisoned_lane_leaves_others():
    """A lane whose every guess is NaN ends unconverged (status 3, fnorm
    inf) and every other lane gets what it gets when solved alone."""
    ladder = np.array(CASES["nan_poisoned"][2])
    ladder[1] = np.nan
    got = port_newton(quadratic_torch, ladder, tol=1e-12)
    assert not got[2][1] and got[4][1] == 3 and np.isinf(got[1][1])
    for lane in (0, 2):
        alone = port_newton(quadratic_torch, ladder[lane:lane + 1], tol=1e-12)
        for g, a in zip(got, alone):
            np.testing.assert_allclose(g[lane:lane + 1], a, rtol=1e-12)


def floor_residuals(lift):
    """test_device_solvers.py's float32 residual (a 64-term sum with ~1e-5
    arithmetic noise) plus a float32 offset ``lift``, in jnp and in torch."""
    ks = np.arange(1.0, 65.0)
    target = np.float32(np.sum(np.sqrt(1.0 + ks * 1.2)))
    lift = np.float32(lift)
    ks32 = jnp.asarray(ks, dtype=jnp.float32)
    kt = torch.tensor(ks, dtype=torch.float32)

    def res_jnp(x):
        x = x.astype(jnp.float32)
        r1 = jnp.sum(jnp.sqrt(x[0] + ks32 * x[1])) - target
        return jnp.stack([r1 / 300.0 + lift, x[1] - 1.2 * x[0]]), jnp.ones(2, jnp.float32)

    def res_torch(X):
        r1 = torch.sqrt(X[:, :1] + kt * X[:, 1:]).sum(dim=1) - torch.tensor(target)
        r = torch.stack([r1 / 300.0 + torch.tensor(lift), X[:, 1] - 1.2 * X[:, 0]], dim=1)
        return r, torch.ones_like(r)

    return res_jnp, res_torch


FLOOR_LADDER = np.array([[[1.1, 1.2]], [[0.9, 1.0]], [[1.3, 1.0]]], np.float32)


def test_newton_solve_reports_precision_floor():
    """The float32 residual with tol 1e-12, lifted by 1.5e-8 (below the
    noise) so that neither summation order can hit an exact zero: both sides
    stall at their measured floor (converged False, status 2, floor > 0 and
    fnorm within 10x of it). The numbers themselves are noise."""
    res_jnp, res_torch = floor_residuals(1.5e-8)
    for x, f, conv, floor, status in (
            ref_newton(res_jnp, FLOOR_LADDER, tol=1e-12, max_iter=60),
            port_newton(res_torch, FLOOR_LADDER, tol=1e-12, max_iter=60)):
        assert x.dtype == np.float32
        assert not conv.any()
        assert (status == 2).all()
        assert (floor > 0.0).all() and (f < 10.0 * floor).all()


def test_newton_solve_precision_floor_without_offset():
    """test_device_solvers.py's float32 case as it is. The two sides differ,
    and only by arithmetic: JAX stalls at its floor (converged False, status
    2, fnorm ~2.4e-8 within 10x of the floor), while torch's summation order
    sums the 64 terms at the root to exactly the target, so its residual
    reaches 0 and every lane converges (status 0) with the same measured
    floor > 0. Both solvers follow the same program (ROADMAP Queue 3)."""
    res_jnp, res_torch = floor_residuals(0.0)
    x, f, conv, floor, status = ref_newton(res_jnp, FLOOR_LADDER, tol=1e-12, max_iter=60)
    assert not conv.any() and (status == 2).all()
    assert (floor > 0.0).all() and (f > 0.0).all() and (f < 10.0 * floor).all()
    x, f, conv, floor, status = port_newton(res_torch, FLOOR_LADDER, tol=1e-12, max_iter=60)
    assert x.dtype == np.float32
    assert conv.all() and (status == 0).all()
    assert (f == 0.0).all() and (floor > 0.0).all()


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
