"""Pseudo-transient continuation solver (reference ``src/clima_ptc.f90``).

Solves f(x) = 0 by damped pseudo-timestepping: each step solves
``(I/dt - J) s = f(x)`` and updates ``x += s``, with TSPSEUDO-style timestep
growth ``dt * increment * |f_prev| / |f|`` (clima_ptc.f90:745-770), step
rejection/rollback with cached residual+Jacobian (:571-637, 773-799), and
stagnation detection.

Both Jacobian modes of the reference are supported: dense (dgesv,
clima_ptc.f90:694-711) and compact-banded (dgbsv, :714-725) — in banded mode
``jac`` returns the LAPACK-compact layout ``ab[ku + i - j, j] = J[i, j]`` of
shape ``(kl + ku + 1, n)`` and the system is solved with
``scipy.linalg.solve_banded``. The optional timestep controls
(``dt0_guess_fac``, ``increment_dt_from_initial_dt``, user ``compute_dt``,
clima_ptc.f90:744-770) are also provided.

Host-side control flow, a copy of the JAX package's
``clima_tpu/solvers/ptc.py``: the linear solve is numpy/scipy (tiny systems,
<= nz+1); the residual/Jacobian callbacks run the port's profile and
radiative transfer on the model's device.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import solve_banded

from ..utils.errors import ClimaException

__all__ = ["PTCSolver", "PTC_CONVERGED_USER", "PTC_REASONS", "PTCInputError"]


class PTCInputError(ClimaException, ValueError):
    """Invalid PTCSolver arguments: a ClimaException, as the port's other
    input errors are, and a ValueError, as the JAX package raises."""


PTC_REASON_NONE = 0
PTC_CONVERGED_PSEUDO_FATOL = 1
PTC_CONVERGED_PSEUDO_FRTOL = 2
PTC_CONVERGED_USER = 3
PTC_DIVERGED_STEP_REJECTED = -1
PTC_DIVERGED_CALLBACK_FATAL = -2
PTC_DIVERGED_MAX_STEPS = -5
PTC_DIVERGED_STAGNATION = -6

PTC_REASONS = {
    PTC_CONVERGED_PSEUDO_FATOL: "converged (fatol)",
    PTC_CONVERGED_PSEUDO_FRTOL: "converged (frtol)",
    PTC_CONVERGED_USER: "converged (user)",
    PTC_DIVERGED_STEP_REJECTED: "step rejected too many times",
    PTC_DIVERGED_CALLBACK_FATAL: "callback failure",
    PTC_DIVERGED_MAX_STEPS: "max steps",
    PTC_DIVERGED_STAGNATION: "stagnation",
}


class PTCSolver:
    def __init__(self, x0, f, jac, dt=None, dt_increment=1.1, dt_max=0.0,
                 fatol=1.0e-50, frtol=1.0e-12, max_steps=10000, max_reject=10,
                 custom_convergence=None, progress=None,
                 stagnation_warmup_steps=10, stagnation_window=150,
                 stagnation_rel_improve_tol=1.0e-3,
                 jacobian_type="dense", kl=None, ku=None,
                 dt0_guess_fac=0.1, increment_dt_from_initial_dt=False,
                 compute_dt=None):
        if jacobian_type not in ("dense", "banded"):
            raise PTCInputError(f"unknown jacobian_type {jacobian_type!r}")
        if jacobian_type == "banded":
            if kl is None or ku is None or kl < 0 or ku < 0:
                raise PTCInputError("banded mode requires kl >= 0 and ku >= 0")
        if dt is not None and dt <= 0.0:
            raise PTCInputError("dt0 must be positive")
        if dt0_guess_fac <= 0.0:
            raise PTCInputError("dt0_guess_fac must be positive")
        if dt_increment <= 0.0:
            raise PTCInputError("dt_increment must be positive")
        self.x = np.asarray(x0, dtype=np.float64).copy()
        self.f = f  # f(x) -> fvec or raises
        # jac(x) -> (n, n) dense, or (kl+ku+1, n) compact banded
        self.jac = jac
        self.jacobian_type = jacobian_type
        self.kl = kl
        self.ku = ku
        self.dt = dt
        self.dt_increment = dt_increment
        self.dt_max = dt_max
        self.fatol = fatol
        self.frtol = frtol
        self.max_steps = max_steps
        self.max_reject = max_reject
        self.custom_convergence = custom_convergence
        self.progress = progress
        self.stagnation_warmup_steps = stagnation_warmup_steps
        self.stagnation_window = stagnation_window
        self.stagnation_rel_improve_tol = stagnation_rel_improve_tol
        self.increment_dt_from_initial_dt = increment_dt_from_initial_dt
        self.compute_dt = compute_dt

        self.fvec = None
        self.fnorm = -1.0
        self.fnorm_initial = -1.0
        self.fnorm_previous = -1.0
        self.fnorm_best = np.inf
        self.stagnation_count = 0
        self.steps = 0
        self.rejects_total = 0
        self.reason = PTC_REASON_NONE
        self._jac_cache = None

        if self.dt is None:
            # auto dt0 = fac / max|diag(J)| capped at 1e12 (clima_ptc.f90:332-360)
            J = np.asarray(self.jac(self.x), dtype=np.float64)
            self._jac_cache = J
            diag = np.diag(J) if self.jacobian_type == "dense" else J[self.ku, :]
            maxdiag = float(np.max(np.abs(diag)))
            self.dt = min(dt0_guess_fac / max(maxdiag, 1e-300), 1.0e12)
        self.dt_initial = self.dt

    def _residual(self, x):
        fvec = np.asarray(self.f(x), dtype=np.float64)
        if not np.all(np.isfinite(fvec)):
            return None, None
        return fvec, float(np.linalg.norm(fvec))

    def _check_convergence(self):
        if self.steps >= self.stagnation_warmup_steps and (
            self.stagnation_count >= self.stagnation_window
        ):
            self.reason = PTC_DIVERGED_STAGNATION
            return
        if self.custom_convergence is not None:
            if self.custom_convergence(self):
                self.reason = PTC_CONVERGED_USER
            return
        if self.fnorm < self.fatol:
            self.reason = PTC_CONVERGED_PSEUDO_FATOL
            return
        if self.fnorm_initial > 0 and self.fnorm / self.fnorm_initial < self.frtol:
            self.reason = PTC_CONVERGED_PSEUDO_FRTOL

    def _update_stagnation(self):
        if self.steps < self.stagnation_warmup_steps or self.fnorm < 0:
            return
        if self.fnorm < self.fnorm_best * (1.0 - self.stagnation_rel_improve_tol):
            self.fnorm_best = self.fnorm
            self.stagnation_count = 0
        elif np.isinf(self.fnorm_best):
            self.fnorm_best = self.fnorm
            self.stagnation_count = 0
        else:
            self.stagnation_count += 1

    def step(self):
        if self.reason != PTC_REASON_NONE:
            return

        if self.fvec is None:
            fvec, fnorm = self._residual(self.x)
            if fvec is None:
                self.reason = PTC_DIVERGED_CALLBACK_FATAL
                return
            self.fvec, self.fnorm = fvec, fnorm
            if self.fnorm_initial < 0:
                self.fnorm_initial = self.fnorm
                self.fnorm_previous = self.fnorm
            if self.progress is not None and self.steps == 0:
                self.progress(self)
            self._check_convergence()
            if self.reason != PTC_REASON_NONE:
                return

        rejections = 0
        while True:
            x_old = self.x.copy()
            fvec_old, fnorm_old = self.fvec, self.fnorm
            jac_old = self._jac_cache

            # linearized update (I/dt - J) s = f
            if self._jac_cache is None:
                try:
                    self._jac_cache = np.asarray(self.jac(self.x), dtype=np.float64)
                except Exception:
                    self.reason = PTC_DIVERGED_CALLBACK_FATAL
                    return
            n = len(self.x)
            try:
                if self.jacobian_type == "dense":
                    A = np.eye(n) / self.dt - self._jac_cache
                    s = np.linalg.solve(A, self.fvec)
                else:
                    # A = I/dt - J in the same compact layout (clima_ptc.f90:714-725)
                    ab = -self._jac_cache.copy()
                    ab[self.ku, :] += 1.0 / self.dt
                    s = solve_banded((self.kl, self.ku), ab, self.fvec)
                ok = np.all(np.isfinite(s))
            except (np.linalg.LinAlgError, ValueError):
                ok = False
            if not ok:
                self.dt = max(0.5 * self.dt, 1e-300)
                self.rejects_total += 1
                rejections += 1
                if rejections > self.max_reject:
                    self.reason = PTC_DIVERGED_STEP_REJECTED
                    return
                continue

            self.x = self.x + s
            self._jac_cache = None

            fvec, fnorm = self._residual(self.x)
            if fvec is None:
                # reject: rollback
                self.x = x_old
                self.fvec, self.fnorm = fvec_old, fnorm_old
                self._jac_cache = jac_old
                self.dt = max(0.5 * self.dt, 1e-300)
                self.rejects_total += 1
                rejections += 1
                if rejections > self.max_reject:
                    self.reason = PTC_DIVERGED_STEP_REJECTED
                    return
                continue

            self.fvec, self.fnorm = fvec, fnorm
            if self.fnorm_initial < 0:
                self.fnorm_initial = self.fnorm
                self.fnorm_previous = self.fnorm

            # TSPSEUDO timestep update (clima_ptc.f90:744-770)
            if self.compute_dt is not None:
                next_dt = self.compute_dt(self)
                # a broken user callback is an error, not something to paper
                # over (the reference's PTCSolver_compute_next_dt errors on
                # non-positive next_dt)
                if not np.isfinite(next_dt) or next_dt <= 0.0:
                    raise ClimaException(
                        f"user compute_dt returned a non-finite or "
                        f"non-positive timestep ({next_dt!r})"
                    )
            else:
                if self.fnorm == 0.0:
                    next_dt = 1.0e12 * self.dt_increment * self.dt
                elif self.increment_dt_from_initial_dt:
                    next_dt = (self.dt_increment * self.dt_initial
                               * self.fnorm_initial / self.fnorm)
                else:
                    next_dt = (self.dt_increment * self.dt
                               * self.fnorm_previous / self.fnorm)
                if self.dt_max > 0:
                    next_dt = min(next_dt, self.dt_max)
            if not np.isfinite(next_dt) or next_dt <= 0.0:
                next_dt = max(self.dt, 1e-300)
            self.dt = next_dt
            self.fnorm_previous = self.fnorm
            self.steps += 1
            self._update_stagnation()
            if self.progress is not None:
                self.progress(self)
            self._check_convergence()
            return

    def solve(self):
        while self.reason == PTC_REASON_NONE:
            if self.steps >= self.max_steps:
                self.reason = PTC_DIVERGED_MAX_STEPS
                break
            self.step()
        return self.reason
