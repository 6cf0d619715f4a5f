"""Small-system nonlinear root solving (hybrd1/hybrj equivalents).

The reference drives MINPACK ``hybrd1`` (FD Jacobian) for make_column /
make_profile_bg_gas / surface_temperature and ``hybrj`` for RCE
(``src/clima_useful.f90:40-80,245-326``). Here the few-DOF host-side solves
use scipy's MINPACK binding on the host (same algorithm, same tolerances);
each residual evaluation runs the port's profile and radiative transfer on
its device.

``ConvergedEarly`` reproduces the reference's custom-convergence escape
(iflag = -77 at ``clima_adiabat_solve.f90:462-467``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConvergedEarly", "SolverError", "hybrd", "hybrj"]


class ConvergedEarly(Exception):
    """Raised by a residual callback to stop with a custom convergence rule."""

    def __init__(self, x, fvec):
        # MUST copy: x/fvec may alias MINPACK work buffers that are freed
        # once the exception unwinds out of scipy.
        self.x = np.array(x, dtype=np.float64, copy=True)
        self.fvec = np.array(fvec, dtype=np.float64, copy=True)


class SolverError(Exception):
    pass


def hybrd(fcn, x0, tol=1.49012e-8, maxfev=0):
    """MINPACK hybrd1 equivalent. Returns (x, info) with info==1 on success."""
    from scipy.optimize import root

    opts = {"xtol": tol}
    if maxfev:
        opts["maxfev"] = maxfev
    try:
        sol = root(fcn, np.asarray(x0, dtype=np.float64), method="hybr", options=opts)
    except ConvergedEarly as e:
        return e.x, 1
    return sol.x, (1 if sol.success else max(sol.status, 2))


def hybrj(fcn, jac, x0, xtol=1.0e-12, maxfev=100):
    """MINPACK hybrj equivalent with user Jacobian.

    Returns (x, fvec, info). The callback may raise ConvergedEarly.
    """
    from scipy.optimize import root

    try:
        sol = root(
            fcn,
            np.asarray(x0, dtype=np.float64),
            jac=jac,
            method="hybr",
            options={"xtol": xtol, "maxfev": maxfev},
        )
    except ConvergedEarly as e:
        return e.x, e.fvec, 1
    return sol.x, sol.fun, (1 if sol.success else max(sol.status, 2))
