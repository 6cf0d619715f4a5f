"""Batched nonlinear solvers for the column constructors, on the model's device.

The port of ``clima_tpu/parallel/solvers.py``. The reference runs one MINPACK
``hybrd1`` per column for ``make_column`` (ng DOF, log10 partial pressures,
``clima_adiabat.f90:476-581``), ``make_profile_bg_gas`` (1 DOF, ``:586-651``)
and ``surface_temperature*`` (1-2 DOF on log10 T_surf [, log10 T_trop],
``:882-1020``). Here each solve is a damped Newton program over a batch of
columns:

- the FD Jacobian with hybrd's relative perturbation, evaluated as one
  batched model call on every column's n perturbed points;
- a vectorised backtracking line search (every step fraction of every column
  in one batched call, the first acceptable one taken); non-finite residuals
  (the NaN poison that replaces the reference's heat-capacity range errors,
  clima_eqns.f90:105-133) reject a trial step like the reference's
  1e30-residual backtracking;
- the reference's initial-guess retry ladder (clima_adiabat.f90:508-541),
  where columns that have converged skip the later guesses.

The JAX package writes the program per column and batches it with ``vmap``
under a ``while_loop``; here a Python loop steps every column with fixed
shapes and updates the active ones with ``torch.where``, one host sync per
iteration. The nested solves of the reference (surface_temperature_column runs
make_column in every residual) are one joint system, as in the JAX package.

With ``mesh`` (:func:`.pipeline.make_mesh`) each rank solves its contiguous
share of the columns and every rank returns the whole batch. A lane's result
does not depend on when another rank's loop stops (a lane that is done keeps
its values), so only the outputs are gathered; they are all per column.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import eqns
from .pipeline import _gather_columns, _local_columns, make_column_fns

__all__ = [
    "newton_solve",
    "batched_make_column",
    "batched_make_profile_bg_gas",
    "batched_surface_temperature_trop",
    "batched_surface_temperature_column",
    "batched_surface_temperature_bg_gas",
]

_TINY_SQRT = np.sqrt(2.2250738585072014e-308)  # clima_adiabat.f90:518


def newton_solve(residual_fn, x0_ladder, *, tol=1.0e-8, max_iter=50, n_backtrack=12,
                 max_line_fails=2):
    """Damped Newton with an FD Jacobian, a line search and a guess ladder,
    for B independent systems at once.

    ``x0_ladder`` (B, L, n): per lane, L initial guesses tried in order
    until one converges. ``residual_fn(X)`` maps N = B*m points X (N, n),
    lane-major (rows b*m ... b*m + m - 1 are lane b's points), to (R, S),
    each (N, n): residuals and positive normalizers. A lane converges when
    max|R/S| < tol (hybrd-style mixed relative criterion). Each call of
    ``residual_fn`` is one batched model evaluation: the lanes' current
    points (m = 1), their Jacobian perturbations (m = n), their line-search
    points (m = n_backtrack) or the precision probes (m = 3). A lane's result
    depends only on its own points.

    Returns ``(x (B, n), fnorm (B,), converged (B,), fnorm_floor (B,),
    status (B,))``:

    - ``fnorm_floor`` is the measured arithmetic-noise level of the
      convergence norm at the returned point: the largest change of the norm
      under 4- and 64-ulp input perturbations, far below any physical signal.
    - ``status``: 0 converged; 2 stalled at the measured floor (fnorm within
      10x of fnorm_floor: raise tol or compute in float64); 3 other (budget
      spent while still improving, or diverged).

    Every lane is evaluated in every call and only the active lanes take the
    result, as in the JAX package's vmapped ``while_loop``: lanes that are
    done cost their share of the batch but keep their values.
    """
    x0_ladder = torch.as_tensor(x0_ladder)
    B, L, n = x0_ladder.shape
    dtype, device = x0_ladder.dtype, x0_ladder.device
    eps = torch.finfo(dtype).eps
    eps_rel = torch.sqrt(torch.tensor(eps, dtype=dtype, device=device))
    h_min = torch.tensor(1.0e-8, dtype=dtype, device=device)
    alphas = 0.5 ** torch.arange(n_backtrack, dtype=dtype, device=device)
    lanes = torch.arange(B, device=device)
    order = torch.arange(n_backtrack, device=device)

    def evaluate(X):
        """X (B, m, n) -> (R, S), each (B, m, n), in one residual call."""
        m = X.shape[1]
        R, S = residual_fn(X.reshape(B * m, n))
        return R.reshape(B, m, n), S.reshape(B, m, n)

    def norms(R, S):
        """max over the last axis of |R/S|, non-finite entries counted as inf."""
        f = torch.abs(R) / S
        return torch.where(torch.isfinite(f), f, torch.inf).amax(dim=-1)

    def stepping(f, it, fails):
        return (f >= tol) & (it < max_iter) & (fails < max_line_fails) & torch.isfinite(f)

    def newton_iteration(x, r, f, fails):
        # hybrd-style FD Jacobian: one call on the B*n perturbed points
        h = eps_rel * torch.maximum(torch.abs(x), h_min)
        Rp, _ = evaluate(x[:, None, :] + torch.diag_embed(h))
        J = (Rp - r[:, None, :]).transpose(1, 2) / h[:, None, :]
        # a singular J gives info != 0 (jnp.linalg.solve gives non-finite
        # values there): either way the step is rejected as a line fail
        sol, info = torch.linalg.solve_ex(J, r[:, :, None])
        step = -sol[:, :, 0]
        step_ok = (info == 0) & torch.isfinite(step).all(dim=1)
        step = torch.where(step_ok[:, None], step, torch.zeros_like(step))

        # vectorised backtracking: one call on the B*n_backtrack trial points
        Xc = x[:, None, :] + alphas[None, :, None] * step[:, None, :]
        Rc, Sc = evaluate(Xc)
        fc = norms(Rc, Sc)
        ok = torch.isfinite(fc) & (fc < f[:, None]) & step_ok[:, None]
        any_ok = ok.any(dim=1)
        # the first (largest-alpha) acceptable step
        first = torch.where(ok, order, n_backtrack).amin(dim=1).clamp(max=n_backtrack - 1)
        x_new = torch.where(any_ok[:, None], Xc[lanes, first], x)
        r_new = torch.where(any_ok[:, None], Rc[lanes, first], r)
        f_new = torch.where(any_ok, fc[lanes, first], f)
        fails = torch.where(any_ok, torch.zeros_like(fails), fails + 1)
        return x_new, r_new, f_new, fails

    best_x = x0_ladder[:, 0].clone()
    best_f = torch.full((B,), torch.inf, dtype=dtype, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    for k in range(L):
        if k > 0 and bool(done.all()):
            break  # every lane skips the remaining guesses
        x = x0_ladder[:, k]
        R, S = evaluate(x[:, None, :])
        r, f = R[:, 0], norms(R, S)[:, 0]
        it = torch.where(done, max_iter, 0)
        fails = torch.zeros(B, dtype=torch.int64, device=device)
        active = stepping(f, it, fails)
        while bool(active.any()):
            x_new, r_new, f_new, fails_new = newton_iteration(x, r, f, fails)
            x = torch.where(active[:, None], x_new, x)
            r = torch.where(active[:, None], r_new, r)
            f = torch.where(active, f_new, f)
            fails = torch.where(active, fails_new, fails)
            it = torch.where(active, it + 1, it)
            active = stepping(f, it, fails)
        improved = (~done) & (f < best_f)
        best_x = torch.where(improved[:, None], x, best_x)
        best_f = torch.where(improved, f, best_f)
        done = done | (f < tol)

    # measured precision floor: the norm's response to ulp-scale input
    # perturbations is arithmetic noise; two probe scales guard against a
    # probe landing inside one flat step of a coarsely quantised residual
    probes = torch.stack([best_x, best_x * (1.0 + 4.0 * eps), best_x * (1.0 + 64.0 * eps)],
                         dim=1)
    fp = norms(*evaluate(probes))
    floor = torch.maximum(torch.abs(fp[:, 1] - fp[:, 0]), torch.abs(fp[:, 2] - fp[:, 0]))
    status = torch.where(done, 0, torch.where(best_f < 10.0 * floor, 2, 3))
    return best_x, best_f, done, floor, status


def _lanes(t, N):
    """Per-lane values (B, ...) repeated for N = B*m lane-major points."""
    return t.repeat_interleave(N // t.shape[0], dim=0)


def _traced_ocean_terms(c, ocean_fcns):
    """The (j, fcn) list of batched ocean reservoirs.

    ``ocean_fcns``: dict {species_name: fcn(T_surf (N,), P_i_bars (N, ng)) ->
    (N, ng) mol/kg molalities}, tensors on the model's device: the batched
    analogue of ``set_ocean_solubility_fcn`` (whose host callables see one
    column at a time), written as torch math over a batch of columns.
    """
    if not ocean_fcns:
        return []
    return [(c.species_names.index(name), fcn) for name, fcn in ocean_fcns.items()]


def _n_total_with_oceans(m, T_surf, ocean_items, gas_masses):
    """N_atmos + N_surface + sum_j N_ocean[:, j] (general.f90:226-246), (N, ng)."""
    N = m["N_atmos"] + m["N_surface"]
    if ocean_items:
        P_i_atm = m["f_i_surf"] * m["P_surf"][:, None]
        for j, fcn in ocean_items:
            m_i = torch.as_tensor(fcn(T_surf, P_i_atm / 1.0e6))
            # an ocean cannot dissolve into itself
            m_i = m_i.index_fill(1, torch.tensor([j], device=m_i.device), 0.0)
            N = N + m_i * m["N_surface"][:, j:j + 1] * (gas_masses[j] / 1.0e3)
    return N


def _with_column(P_i, ind, values):
    """P_i (N, ng) with column ``ind`` replaced by ``values`` (N,)."""
    return torch.cat([P_i[:, :ind], values[:, None], P_i[:, ind + 1:]], dim=1)


def _model_tensors(c):
    """Arrays, sequences or tensors (on any device) to tensors on the model's
    device and dtype."""
    return lambda x: torch.as_tensor(x, dtype=c.dtype, device=c.device)


def _reservoir_ladder(t, N_i_b, gas_masses, grav, scales):
    """log10(N_i * m_i * g * scale) per guess (clima_adiabat.f90:529-532), (B, L, ng)."""
    return torch.log10(torch.clamp(
        N_i_b[:, None, :] * t(gas_masses)[None, None, :] * grav * t(scales)[None, :, None],
        min=_TINY_SQRT))


def batched_make_column(c, T_surf_b, N_i_b, mesh=None, tol=None, max_iter=50,
                        ocean_fcns=None):
    """Batched ``make_column`` (clima_adiabat.f90:476-581) on ``c.device``.

    Solves log10(P_i_surf) per column such that
    N_atmos + N_surface + sum_j N_ocean[:, j] = N_i target (mol/cm^2).
    ``ocean_fcns``: optional dict {species_name: fcn(T_surf (N,), P_i_bars
    (N, ng)) -> (N, ng) mol/kg} of batched solubility laws on the model's
    device (see ``_traced_ocean_terms``); the residual then includes the
    dissolved reservoirs as the host ``make_column`` does.

    Returns dict(P_i_surf (B, ng), fnorm, converged, fnorm_floor, status).
    """
    N_i_b, T_surf_b = _local_columns(mesh, N_i_b, T_surf_b)
    profile_only = make_column_fns(c)["profile_only"]
    T_trop = float(c.T_trop)
    tol = float(c.tol_make_column) if tol is None else tol
    grav = float(eqns.gravity(c.planet_radius, c.planet_mass, 0.0))
    gas_masses = np.asarray(c.sp.gas_masses)
    ocean_items = _traced_ocean_terms(c, ocean_fcns)
    scales = np.array([1.0, 0.5, 2.0, 0.1, 5.0, 0.01])  # clima_adiabat.f90:528

    t = _model_tensors(c)
    T_surf_b, N_i_b = t(T_surf_b), t(N_i_b)
    ladder = _reservoir_ladder(t, N_i_b, gas_masses, grav, scales)  # (B, 6, ng)
    scale = torch.clamp(torch.abs(N_i_b), min=1.0e-30)

    def residual(X):
        T_surf = _lanes(T_surf_b, X.shape[0])
        m = profile_only(T_surf, 10.0 ** X, T_trop)
        N = _n_total_with_oceans(m, T_surf, ocean_items, gas_masses)
        return N - _lanes(N_i_b, X.shape[0]), _lanes(scale, X.shape[0])

    x, f, conv, floor, status = newton_solve(residual, ladder, tol=tol, max_iter=max_iter)
    return _gather_columns(mesh, dict(P_i_surf=10.0 ** x, fnorm=f, converged=conv,
                                      fnorm_floor=floor, status=status))


def batched_make_profile_bg_gas(c, T_surf_b, P_i_b, P_surf_b, bg_gas, mesh=None, tol=1.0e-8,
                                max_iter=50):
    """Batched ``make_profile_bg_gas`` (clima_adiabat.f90:586-651) on ``c.device``.

    Solves log10 of the background gas's surface partial pressure per column
    so the total surface pressure equals ``P_surf`` (dynes/cm^2).

    Returns dict(P_i_surf (B, ng) with the solved bg entry, fnorm, converged,
    fnorm_floor, status).
    """
    P_i_b, T_surf_b, P_surf_b = _local_columns(mesh, P_i_b, T_surf_b, P_surf_b)
    profile_only = make_column_fns(c)["profile_only"]
    T_trop = float(c.T_trop)
    ind = c.species_names.index(bg_gas)

    t = _model_tensors(c)
    T_surf_b, P_i_b, P_surf_b = t(T_surf_b), t(P_i_b), t(P_surf_b)
    scales = t([1.0, 0.1])  # clima_adiabat.f90:628-635
    ladder = torch.log10(P_surf_b[:, None, None] * scales[None, :, None])  # (B, 2, 1)

    def residual(X):
        N = X.shape[0]
        m = profile_only(_lanes(T_surf_b, N), _with_column(_lanes(P_i_b, N), ind, 10.0 ** X[:, 0]),
                         T_trop)
        P_target = _lanes(P_surf_b, N)
        return (m["P_surf"] - P_target)[:, None], P_target[:, None]

    x, f, conv, floor, status = newton_solve(residual, ladder, tol=tol, max_iter=max_iter)
    return _gather_columns(mesh, dict(P_i_surf=_with_column(P_i_b, ind, 10.0 ** x[:, 0]),
                                      fnorm=f, converged=conv, fnorm_floor=floor,
                                      status=status))


def _energy_residual_parts(m, surface_heat_flow):
    """ISR - OLR + surface_heat_flow with its scale (clima_adiabat.f90:951)."""
    r = m["ISR"] - m["OLR"] + surface_heat_flow
    return r, torch.clamp(torch.abs(m["ISR"]), min=1.0)


def _t_guess_ladder(t, T_guess, B):
    """log10 T ladder (B, 3): the guess, then -+5% perturbations."""
    logT = torch.log10(torch.broadcast_to(t(T_guess), (B,)))
    return logT[:, None] + t([0.0, np.log10(0.95), np.log10(1.05)])[None, :]


def batched_surface_temperature_trop(c, P_i_b, T_guess=280.0, mesh=None, tol=1.0e-8,
                                     max_iter=50):
    """Batched ``surface_temperature`` with ``solve_for_T_trop``, on ``c.device``.

    The 2-DOF system of clima_adiabat.f90:882-1020: unknowns [log10 T_surf,
    log10 T_trop], residuals [ISR - OLR + surface_heat_flow,
    skin_temperature(bolometric_flux, bond_albedo) - T_trop].

    Returns dict(T_surf (B,), T_trop (B,), fnorm, converged, fnorm_floor,
    status).
    """
    P_i_b, T_guess = _local_columns(mesh, P_i_b, T_guess)
    column_model = make_column_fns(c)["column_model"]
    shf = float(c.surface_heat_flow)
    bolometric = float(c.rad.bolometric_flux())

    t = _model_tensors(c)
    P_i_b = t(P_i_b)
    lt = _t_guess_ladder(t, T_guess, P_i_b.shape[0])  # (B, 3)
    ltrop = torch.full_like(lt, np.log10(float(c.T_trop)))
    ladder = torch.stack([lt, ltrop], dim=-1)  # (B, 3, 2)

    def residual(X):
        T_surf, T_trop = 10.0 ** X[:, 0], 10.0 ** X[:, 1]
        m = column_model(T_surf, _lanes(P_i_b, X.shape[0]), T_trop)
        r1, s1 = _energy_residual_parts(m, shf)
        bond_albedo = m["fup_sol_toa"] / m["fdn_sol_toa"]
        r2 = eqns.skin_temperature(bolometric, bond_albedo) - T_trop
        return torch.stack([r1, r2], dim=-1), torch.stack([s1, T_trop], dim=-1)

    x, f, conv, floor, status = newton_solve(residual, ladder, tol=tol, max_iter=max_iter)
    return _gather_columns(mesh, dict(T_surf=10.0 ** x[:, 0], T_trop=10.0 ** x[:, 1], fnorm=f,
                                      converged=conv, fnorm_floor=floor, status=status))


def batched_surface_temperature_column(c, N_i_b, T_guess=280.0, mesh=None, tol=1.0e-8,
                                       max_iter=60, ocean_fcns=None):
    """Batched ``surface_temperature_column`` (clima_adiabat.f90:984-999) on
    ``c.device``.

    The reference nests hybrd1 solves (an ng-DOF make_column inside every
    residual of a 1-DOF T solve). Here the (1+ng)-DOF joint system
    [energy balance; N(P_i) - N_target] is solved at once: the same fixed
    point. ``ocean_fcns`` as in :func:`batched_make_column`.

    Returns dict(T_surf (B,), P_i_surf (B, ng), fnorm, converged,
    fnorm_floor, status).
    """
    N_i_b, T_guess = _local_columns(mesh, N_i_b, T_guess)
    column_model = make_column_fns(c)["column_model"]
    T_trop = float(c.T_trop)
    shf = float(c.surface_heat_flow)
    grav = float(eqns.gravity(c.planet_radius, c.planet_mass, 0.0))
    gas_masses = np.asarray(c.sp.gas_masses)
    ocean_items = _traced_ocean_terms(c, ocean_fcns)

    t = _model_tensors(c)
    N_i_b = t(N_i_b)
    lt = _t_guess_ladder(t, T_guess, N_i_b.shape[0])  # (B, 3)
    lp = _reservoir_ladder(t, N_i_b, gas_masses, grav, np.array([1.0, 0.5, 2.0]))
    ladder = torch.cat([lt[:, :, None], lp], dim=-1)  # (B, 3, 1+ng)
    sN = torch.clamp(torch.abs(N_i_b), min=1.0e-30)

    def residual(X):
        N = X.shape[0]
        T_surf = 10.0 ** X[:, 0]
        m = column_model(T_surf, 10.0 ** X[:, 1:], T_trop)
        r1, s1 = _energy_residual_parts(m, shf)
        N_tot = _n_total_with_oceans(m, T_surf, ocean_items, gas_masses)
        return (torch.cat([r1[:, None], N_tot - _lanes(N_i_b, N)], dim=1),
                torch.cat([s1[:, None], _lanes(sN, N)], dim=1))

    x, f, conv, floor, status = newton_solve(residual, ladder, tol=tol, max_iter=max_iter)
    return _gather_columns(mesh, dict(T_surf=10.0 ** x[:, 0], P_i_surf=10.0 ** x[:, 1:],
                                      fnorm=f, converged=conv, fnorm_floor=floor,
                                      status=status))


def batched_surface_temperature_bg_gas(c, P_i_b, P_surf_b, bg_gas, T_guess=280.0, mesh=None,
                                       tol=1.0e-8, max_iter=60):
    """Batched ``surface_temperature_bg_gas`` (clima_adiabat.f90:1003-1020) on
    ``c.device``.

    Joint 2-DOF system [energy balance; P_surf(P_bg) - P_target] over
    [log10 T_surf, log10 P_bg]: the same fixed point as the reference's
    nested solves.

    Returns dict(T_surf (B,), P_i_surf (B, ng), fnorm, converged,
    fnorm_floor, status).
    """
    P_i_b, P_surf_b, T_guess = _local_columns(mesh, P_i_b, P_surf_b, T_guess)
    column_model = make_column_fns(c)["column_model"]
    T_trop = float(c.T_trop)
    shf = float(c.surface_heat_flow)
    ind = c.species_names.index(bg_gas)

    t = _model_tensors(c)
    P_i_b, P_surf_b = t(P_i_b), t(P_surf_b)
    lt = _t_guess_ladder(t, T_guess, P_i_b.shape[0])  # (B, 3)
    lp = torch.log10(P_surf_b)[:, None] * torch.ones_like(lt)
    lp = lp + t([0.0, -1.0, 0.0])[None, :]  # scales 1.0, 0.1, 1.0
    ladder = torch.stack([lt, lp], dim=-1)  # (B, 3, 2)

    def residual(X):
        N = X.shape[0]
        P_full = _with_column(_lanes(P_i_b, N), ind, 10.0 ** X[:, 1])
        m = column_model(10.0 ** X[:, 0], P_full, T_trop)
        r1, s1 = _energy_residual_parts(m, shf)
        P_target = _lanes(P_surf_b, N)
        return (torch.stack([r1, m["P_surf"] - P_target], dim=-1),
                torch.stack([s1, P_target], dim=-1))

    x, f, conv, floor, status = newton_solve(residual, ladder, tol=tol, max_iter=max_iter)
    return _gather_columns(mesh, dict(T_surf=10.0 ** x[:, 0],
                                      P_i_surf=_with_column(P_i_b, ind, 10.0 ** x[:, 1]),
                                      fnorm=f, converged=conv, fnorm_floor=floor,
                                      status=status))
