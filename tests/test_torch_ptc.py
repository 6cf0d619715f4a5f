"""PTCSolver of the PyTorch port against clima_tpu's (float64, host numpy).

The problems of tests/test_ptc.py: both Jacobian modes (dense, compact
banded), both dt-update variants and a user compute_dt, and rollback on
non-finite residuals. The two solvers run side by side from the same start;
every iterate, dt and residual norm matches at rtol 1e-12, and both stop
with the same reason after the same steps and rejections.
"""

import numpy as np
import pytest

from clima_tpu.solvers.ptc import PTCSolver as RefPTCSolver

from clima_tpu_torch import ClimaException
from clima_tpu_torch.solvers import PTCSolver

RTOL = 1e-12


def _tridiag_problem(n=12):
    """Stable nonlinear ODE rhs x' = f(x) with tridiagonal Jacobian (as in
    tests/test_ptc.py): f = -(A x + 0.1 tanh(x) - b), A the 1-D Laplacian."""
    rng = np.random.default_rng(7)
    b = rng.uniform(0.5, 1.5, n)

    def f(x):
        r = np.empty(n)
        r[0] = 2 * x[0] - x[1] + 0.1 * np.tanh(x[0]) - b[0]
        r[1:-1] = 2 * x[1:-1] - x[:-2] - x[2:] + 0.1 * np.tanh(x[1:-1]) - b[1:-1]
        r[-1] = 2 * x[-1] - x[-2] + 0.1 * np.tanh(x[-1]) - b[-1]
        return -r

    def jac_dense(x):
        J = np.diag(2.0 + 0.1 / np.cosh(x) ** 2)
        J += np.diag(-np.ones(n - 1), 1) + np.diag(-np.ones(n - 1), -1)
        return -J

    def jac_banded(x):
        ab = np.zeros((3, n))  # ab[ku + i - j, j] = J[i, j], kl = ku = 1
        ab[1, :] = -(2.0 + 0.1 / np.cosh(x) ** 2)
        ab[0, 1:] = 1.0
        ab[2, :-1] = 1.0
        return ab

    return np.zeros(n), f, jac_dense, jac_banded


def _rollback_problem(n=4):
    """Residual calls 2 and 3 return NaN: two rollbacks with dt halving."""
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        if calls["n"] in (2, 3):
            return np.full(n, np.nan)
        return -(x - 1.0)

    return np.full(n, 5.0), f, lambda x: -np.eye(n)


def _case(name):
    """(x0, f, jac, kwargs) of a case; each call builds fresh callbacks."""
    if name == "rollback":
        x0, f, jac = _rollback_problem()
        return x0, f, jac, dict(dt=1.0, frtol=1e-12)
    x0, f, jd, jb = _tridiag_problem()
    return {
        "dense": (x0, f, jd, dict(frtol=1e-12)),
        "banded": (x0, f, jb, dict(frtol=1e-12, jacobian_type="banded", kl=1, ku=1)),
        "increment_dt_from_initial_dt": (x0, f, jd, dict(frtol=1e-12,
                                                         increment_dt_from_initial_dt=True)),
        "compute_dt": (x0, f, jd, dict(frtol=1e-12, compute_dt=lambda s: s.dt * 2.0)),
    }[name]


@pytest.mark.parametrize("name", ["dense", "banded", "increment_dt_from_initial_dt",
                                  "compute_dt", "rollback"])
def test_ptc_matches_reference(name):
    histories = []
    for cls in (PTCSolver, RefPTCSolver):
        x0, f, jac, kw = _case(name)
        history = []
        s = cls(x0, f, jac, progress=lambda s: history.append((s.x.copy(), s.dt, s.fnorm)),
                **kw)
        reason = s.solve()
        histories.append((history, reason, s.steps, s.rejects_total, s.x))
    (got, reason, steps, rejects, x), (want, ref_reason, ref_steps, ref_rejects, ref_x) = histories
    assert reason > 0 and (reason, steps, rejects) == (ref_reason, ref_steps, ref_rejects)
    assert len(got) == len(want) == steps + 1
    for (xg, dtg, fg), (xw, dtw, fw) in zip(got, want):
        np.testing.assert_allclose(xg, xw, rtol=RTOL, atol=1e-300)
        np.testing.assert_allclose([dtg, fg], [dtw, fw], rtol=RTOL)
    np.testing.assert_allclose(x, ref_x, rtol=RTOL)
    if name == "rollback":
        assert rejects == 2
        np.testing.assert_allclose(x, 1.0, atol=1e-8)


@pytest.mark.parametrize("kwargs", [dict(jacobian_type="banded"), dict(jacobian_type="sparse"),
                                    dict(dt=-1.0), dict(dt_increment=0.0),
                                    dict(dt0_guess_fac=0.0)])
def test_ptc_invalid_inputs_raise(kwargs):
    """Invalid arguments raise ClimaException; it is also the ValueError that
    the JAX package raises for them."""
    f, jac = (lambda x: x), (lambda x: np.eye(2))
    with pytest.raises(ValueError):
        RefPTCSolver(np.zeros(2), f, jac, **kwargs)
    with pytest.raises(ClimaException) as err:
        PTCSolver(np.zeros(2), f, jac, **kwargs)
    assert isinstance(err.value, ValueError)
