"""The batched damped-Newton solver ``newton_solve`` of the PyTorch port
against clima_tpu.parallel.solvers' (float64, CPU), on analytic residuals:
the NaN-poisoned quadratic of ``test_device_solvers.py``, a residual whose
FD Jacobian is singular at a lane's first guess, a poisoned lane beside
healthy ones, and the float32 precision-floor case.

The ``batched_*`` solves on a model are in test_torch_solvers_column.py
(``batched_make_column``, ``batched_make_profile_bg_gas``) and
test_torch_solvers_surface.py (the three surface-temperature solves); on the
JAX side each is the JAX package's own program (ladders, residual assembly,
``newton_solve`` under ``vmap``) with one change: its column model is
evaluated column by column by the JAX package's jitted per-column function
through ``jax.pure_callback``. Tracing the model inline under the solver's
nested ``vmap`` costs 60-160 s a solve on the CPU; the callback leaves the
solver's trace small and compiles the model once for the module.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from clima_tpu.parallel import solvers as ref_solvers

from clima_tpu_torch.parallel import newton_solve
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


EPS64 = np.finfo(np.float64).eps


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


