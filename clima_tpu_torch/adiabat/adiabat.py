"""The AdiabatClimate model (reference ``src/adiabat/clima_adiabat.f90``).

Public surface mirrors the JAX package's ``clima_tpu.adiabat.AdiabatClimate``
(and through it the reference Cython class ``AdiabatClimate.pyx``): profile
constructors, TOA fluxes, surface-temperature solvers, particle setters,
ocean-solubility callbacks, regridding/output utilities and the
tidally-locked heat-redistribution parameters. RCE lives in :mod:`.rce`,
which attaches its methods to the class, as the JAX package's does.

Architecture: profile construction and the altitude integration run on the
model's device as batches of one column (:mod:`.profile`, :mod:`.altitude`);
the few-DOF nonlinear solves (make_column / bg-gas / surface_temperature) use
MINPACK via scipy on the host, each residual evaluation running one profile
and one radiative transfer on the device, as the reference's hybrd1 usage
does (clima_adiabat.f90:476-651,882-1020). Results are copied to host numpy
after each profile, as in the JAX package. Batched, device-resident column
functions are in :mod:`..parallel.pipeline`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import constants as const
from ..config import load_settings, load_species, species_from_dict
from ..config.species import heat_capacity
from ..ops.rebin import rebin
from ..physics import eqns
from ..radtran import Radtran, optical_data_from_numpy
from ..solvers.newton import hybrd
from ..utils.device import resolve_device
from ..utils.errors import ClimaException
from .altitude import compute_altitude_core
from .profile import AdiabatParams, make_profile_core
from .profile_dry import make_profile_dry_core

__all__ = ["AdiabatClimate", "FREE_PARAMETERS", "RCE_SOLVE_HYBRJ_ONLY",
           "RCE_SOLVE_PTC_THEN_HYBRJ", "RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ"]

RCE_SOLVE_HYBRJ_ONLY = 1
RCE_SOLVE_PTC_THEN_HYBRJ = 2
RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ = 3

# Host attributes a user may set between calls; AdiabatClimate.from_reference
# copies them (and the substeps, particle grids and Radtran surface settings).
FREE_PARAMETERS = (
    "P_top", "T_trop", "RH", "use_make_column_P_guess", "make_column_P_guess",
    "solve_for_T_trop", "albedo_fcn", "ocean_fcns", "ocean_args_p",
    "tidally_locked_dayside", "L", "chi", "n_LW", "Cd", "surface_heat_flow",
    "reference_pressure", "rtol", "atol", "tol_make_column", "verbose",
    "epsj", "xtol_rc", "dt_increment", "max_rc_iters", "max_rc_iters_convection",
    "compute_solar_in_jac", "rce_solve_strategy", "convective_newton_step_size",
    "convective_hysteresis_frac_on", "convective_hysteresis_frac_off",
    "convective_hysteresis_min", "convective_max_boundary_shift", "prevent_overconvection",
    "require_mode2",
)
_RAD_PARAMETERS = ("surface_albedo", "surface_emissivity", "has_hard_surface", "ir_tau_min",
                   "diurnal_fac", "photon_scale_factor")
_PARTICLE_GRIDS = ("_particle_log10P", "_particle_log10_dens", "_particle_log10_radii")


class AdiabatClimate:
    """Multispecies pseudoadiabat climate model (clima_adiabat.f90:19-224).

    ``species_file`` is a species.yaml path or its parsed document,
    ``settings_file`` a settings.yaml path or a ClimaSettings, ``flux_file``
    a star file path or its (n, 2) table and ``data_dir`` a path or an
    in-memory data tree (:func:`..data.make_template` gives all four).
    ``device`` None means the CUDA card (raises without one); pass "cpu" for
    the CPU.
    """

    def __init__(self, species_file, settings_file, flux_file, data_dir,
                 double_radiative_grid=True, substeps=6, device=None, dtype=torch.float64):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.sp = (load_species(species_file) if isinstance(species_file, str)
                   else species_from_dict(species_file))
        self.species_names = list(self.sp.gas_names)
        self.particle_names = list(self.sp.particle_names)
        if self.sp.ng == 1:
            raise ClimaException(f'There must be more than 1 species in "{species_file}"')

        s = load_settings(settings_file) if isinstance(settings_file, str) else settings_file
        if not s.atmos_grid_is_present:
            raise ClimaException(f'"atmosphere-grid" is missing from file "{s.filename}"')
        if not s.planet_is_present:
            raise ClimaException(f'"planet" is missing from file "{s.filename}"')
        if s.number_of_zenith_angles is None:
            raise ClimaException(
                f'"number-of-zenith-angles" is missing from file "{s.filename}"'
            )
        if s.surface_albedo is None:
            raise ClimaException(f'"surface-albedo" is missing from file "{s.filename}"')

        self.nz = s.nz
        self.planet_mass = s.planet_mass
        self.planet_radius = s.planet_radius

        # free parameters (defaults at clima_adiabat.f90:19-158)
        self.P_top = 1.0  # dynes/cm^2
        self.T_trop = 180.0
        self.RH = np.ones(self.sp.ng)
        self.use_make_column_P_guess = True
        self.make_column_P_guess = np.ones(self.sp.ng)
        self.solve_for_T_trop = False
        self.albedo_fcn = None
        self.ocean_fcns = [None] * self.sp.ng
        self.ocean_args_p = None
        self.tidally_locked_dayside = False
        self.L = self.planet_radius
        self.chi = 0.2
        self.n_LW = 2.0
        self.Cd = 1.9e-3
        self.surface_heat_flow = 0.0
        self.reference_pressure = -1.0
        self.rtol = 1.0e-9
        self.atol = 1.0e-12
        self.tol_make_column = 1.0e-8
        self.epsj = 1.0e-2
        self.xtol_rc = 1.0e-5
        self.dt_increment = 1.5
        self.max_rc_iters = 30
        self.max_rc_iters_convection = 5
        self.compute_solar_in_jac = False
        self.rce_solve_strategy = RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ
        self.verbose = True
        self.convective_newton_step_size = 1.0e-1
        self.convective_hysteresis_frac_on = 2.0e-2
        self.convective_hysteresis_frac_off = 2.0e-2
        self.convective_hysteresis_min = 1.0e-3
        self.convective_max_boundary_shift = -1
        self.prevent_overconvection = True
        self.require_mode2 = True

        self.double_radiative_grid = double_radiative_grid
        self.nz_r = 2 * self.nz + 2 if double_radiative_grid else self.nz

        self.rad = Radtran(
            self.species_names, self.particle_names, s, flux_file,
            s.number_of_zenith_angles, s.surface_albedo, self.nz_r, data_dir,
            device=self.device, dtype=dtype,
        )

        # state
        ng, nz, np_ = self.sp.ng, self.nz, self.sp.np_
        self.f_i_surf = np.zeros(ng)
        self.P_surf = 0.0
        self.P_trop = -1.0
        self.P = np.zeros(nz)
        self.T_surf = 0.0
        self.T = np.zeros(nz)
        self.f_i = np.zeros((nz, ng))
        self.z = np.zeros(nz)
        self.dz = np.zeros(nz)
        self.gravity_surf = 0.0
        self.gravity = np.zeros(nz)
        self.densities = np.zeros((nz, ng))
        self.N_atmos = np.zeros(ng)
        self.N_surface = np.zeros(ng)
        self.N_ocean = np.zeros((ng, ng))
        self.pdensities = np.zeros((nz, np_))
        self.pradii = np.full((nz, np_), 1.0e-4)

        # convection bookkeeping (filled by make_profile / RCE)
        self.convecting_with_below = np.zeros(nz, dtype=bool)
        self.super_saturated = np.zeros(nz, dtype=bool)
        self.lapse_rate = np.zeros(nz)
        self.lapse_rate_intended = np.zeros(nz)
        self.n_convecting_zones = 0

        # custom mixing ratios (set via RCE)
        self.sp_custom = np.zeros(ng, dtype=bool)
        self._mix_custom_grid = None  # (log10P ascending, log10mix (nP, ng))
        self._rc_graphs = {}  # the RC march's captured interval, by shape (CUDA)

        # particle interpolators: default no particles, 1 micron radii
        P_default = 10.0 ** np.linspace(0.0, -5.0, nz)
        self.set_particle_density_and_radii(
            P_default, np.zeros((nz, np_)), np.full((nz, np_), 1.0e-4)
        )

        self._par = AdiabatParams.from_species(
            self.sp, self.nz, self.planet_mass, self.planet_radius, self.P_top, substeps,
            self.device, dtype,
        )

    @classmethod
    def from_reference(cls, ref, species_file, settings_file, flux_file, data_dir,
                       device=None, dtype=torch.float64):
        """The port's model of the same inputs as ``ref``, computing the same thing.

        ``ref`` is an AdiabatClimate-like object with the same attribute names
        and numpy (or array-like) values, such as the JAX package's, built from
        the same species, settings, star and data. The port's model gets
        ``ref``'s opacity tables (:func:`..radtran.optical_data_from_numpy`),
        so both compute on identical tables, and ``ref``'s free parameters
        (:data:`FREE_PARAMETERS`, the substeps, the particle interpolation grids
        and the Radtran surface settings), as numpy arrays and Python scalars.
        """
        c = cls(species_file, settings_file, flux_file, data_dir,
                double_radiative_grid=ref.double_radiative_grid, substeps=ref.substeps,
                device=device, dtype=dtype)
        op, _, _ = optical_data_from_numpy(ref.rad.op, ref.rad.ir, ref.rad.sol,
                                           c.device, dtype)
        c.rad.op = op
        c.rad._opr = None
        c._copy_free_parameters(ref)
        return c

    def _copy_free_parameters(self, src):
        def host(v):
            if isinstance(v, (bool, int, float, str, list, tuple, type(None))) or callable(v):
                return list(v) if isinstance(v, list) else v
            return np.array(v, dtype=np.asarray(v).dtype)

        for name in FREE_PARAMETERS:
            setattr(self, name, host(getattr(src, name)))
        self.substeps = src.substeps
        for name in _PARTICLE_GRIDS:
            setattr(self, name, np.array(getattr(src, name), dtype=np.float64))
        for name in _RAD_PARAMETERS:
            setattr(self.rad, name, host(getattr(src.rad, name)))

    @property
    def substeps(self):
        """RK4 substeps per profile grid interval.

        The reference resolves profiles with an adaptive dop853 integrator at
        rtol=1e-9 (clima_adiabat_general.f90:274-353); here accuracy is set by
        fixed 4th-order substeps per log-P interval, as in the JAX package
        (error decays as substeps**-4).
        """
        return self._par.substeps

    @substeps.setter
    def substeps(self, value):
        value = int(value)
        if value < 1:
            raise ClimaException("substeps must be >= 1")
        self._par = dataclasses.replace(self._par, substeps=value)

    def _tensor(self, x):
        """Numbers, sequences, arrays or tensors on any device as a tensor of
        the model's dtype on its device."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    @staticmethod
    def _host(out):
        """Batch-of-one device results -> host numpy, batch axis dropped."""
        return {k: v[0].detach().cpu().numpy() for k, v in out.items()}

    # ------------------------------------------------------------------
    # profile constructors
    # ------------------------------------------------------------------

    def make_profile(self, T_surf, P_i_surf):
        """Moist pseudoadiabat from surface partial pressures (clima_adiabat.f90:401-472)."""
        P_i_surf = np.asarray(P_i_surf, dtype=np.float64)
        if P_i_surf.shape != (self.sp.ng,):
            raise ClimaException("P_i_surf has the wrong dimension")
        if np.any(P_i_surf < 0):
            raise ClimaException(
                'make_profile: Surface pressures (input "P_i_surf") must be positive'
            )
        if T_surf < self.T_trop:
            raise ClimaException('make_profile: Input "T_surf" is less than input "T_trop"')
        if self.T_trop < 0:
            raise ClimaException('make_profile: Input "T_trop" is less than 0')

        par = dataclasses.replace(self._par, P_top=float(self.P_top))
        out = self._host(make_profile_core(
            par, self._tensor(self.RH), self._tensor([T_surf]), self._tensor(P_i_surf[None]),
            float(self.T_trop),
        ))
        P_surf = float(out["P_surf"])
        if self.P_top > P_surf:
            raise ClimaException('make_profile: "P_top" is bigger than the surface pressure')
        if np.any(out["z_e"] < 0):
            raise ClimaException(
                '"make_profile" yielded negative altitudes. This may be caused by the '
                "lack of a hydrostatic solution to the entered atmosphere."
            )

        self._finish_profile(T_surf, out)

        # oceans dissolve gases (general.f90:226-246)
        P_i_atm = out["f_i_e"][0] * P_surf
        self._ocean_reservoirs(T_surf, P_i_atm)

        # convection mask from the tropopause (clima_adiabat.f90:459-465)
        self.convecting_with_below = self.P > self.P_trop
        self._set_lapse_rates()

    def _finish_profile(self, T_surf, out):
        """Common post-profile state fill (clima_adiabat.f90:432-457)."""
        P_e, T_e, f_i_e = out["P_e"], out["T_e"], out["f_i_e"]
        # NaN-poison check: heat_capacity returns NaN outside the thermo
        # tables' temperature ranges (the reference errors there,
        # clima_eqns.f90:105-133); raising here lets hybrd backtrack instead
        # of silently extrapolating the polynomials.
        if not (np.isfinite(T_e).all() and np.isfinite(P_e).all()
                and np.isfinite(f_i_e).all()):
            raise ClimaException(
                "profile construction produced non-finite values, most likely a "
                "temperature outside the thermodynamic data's valid range (the "
                "reference errors in heat_capacity_eval, clima_eqns.f90:105-133)"
            )
        self.f_i_surf = f_i_e[0].copy()
        self.T_surf = float(T_surf)
        self.P_surf = float(P_e[0])
        self.P_trop = float(out.get("P_trop", -1.0))
        self.P = P_e[1::2].copy()
        self.T = T_e[1::2].copy()
        self.f_i = f_i_e[1::2].copy()
        self.N_surface = np.asarray(out.get("N_surface", np.zeros(self.sp.ng))).copy()

        self.compute_altitude()

        density = self.P / (const.k_boltz * self.T)
        self.densities = self.f_i * density[:, None]
        self.interpolate_particles(self.P)
        self.N_atmos = (
            np.sum(density[:, None] * self.f_i * self.dz[:, None], axis=0) / const.N_avo
        )

    def _set_lapse_rates(self):
        logT = np.log(np.concatenate([[self.T_surf], self.T]))
        logP = np.log(np.concatenate([[self.P_surf], self.P]))
        self.lapse_rate = np.diff(logT) / np.diff(logP)

    def _ocean_reservoirs(self, T_surf, P_i_atm):
        """N_ocean from user solubility callbacks (general.f90:226-246)."""
        ng = self.sp.ng
        self.N_ocean = np.zeros((ng, ng))
        for j in range(ng):
            fcn = self.ocean_fcns[j]
            if fcn is None:
                continue
            m_i = np.asarray(fcn(float(T_surf), ng, P_i_atm / 1.0e6, self.ocean_args_p))
            for i in range(ng):
                if i != j:
                    self.N_ocean[i, j] = (
                        m_i[i] * self.N_surface[j] * (self.sp.gas_masses[j] / 1.0e3)
                    )

    def compute_altitude(self):
        """z/dz/gravity from the current P/T/f_i state (clima_adiabat_altitude.f90)."""
        mubar = self.f_i @ self.sp.gas_masses
        mubar_surf = self.f_i_surf @ self.sp.gas_masses
        if self.reference_pressure > 0 and not (
            self.P_top <= self.reference_pressure <= self.P_surf
        ):
            raise ClimaException(
                f"compute_altitude: reference_pressure={self.reference_pressure} outside "
                "model domain"
            )
        t = self._tensor
        out = self._host(compute_altitude_core(
            t(self.P[None]), t(self.T[None]), t(mubar[None]), t([self.P_surf]),
            t([self.T_surf]), t([mubar_surf]), float(self.P_top), self.planet_mass,
            self.planet_radius, float(self.reference_pressure),
        ))
        self.z = out["z"]
        self.dz = out["dz"]
        self.gravity = out["gravity"]
        self.gravity_surf = float(out["gravity_surf"])

    def make_column(self, T_surf, N_i_surf):
        """Column-reservoir constructor via nonlinear solve (clima_adiabat.f90:476-581)."""
        N_i_surf = np.asarray(N_i_surf, dtype=np.float64)
        if N_i_surf.shape != (self.sp.ng,):
            raise ClimaException("N_i_surf has the wrong dimension")

        grav = float(eqns.gravity(self.planet_radius, self.planet_mass, 0.0))
        err_box = [None]

        def fcn(x):
            with np.errstate(over="ignore"):
                P_i = 10.0**x
            if np.any(~np.isfinite(P_i)):
                err_box[0] = "infinity values were encountered."
                return np.full_like(x, 1e30)
            try:
                self.make_profile(T_surf, P_i)
            except ClimaException as e:
                err_box[0] = str(e)
                return np.full_like(x, 1e30)
            err_box[0] = None
            N_i = self.N_atmos + self.N_surface + np.sum(self.N_ocean, axis=1)
            return N_i - N_i_surf

        tiny_sqrt = np.sqrt(2.2250738585072014e-308)
        info = 0
        if self.use_make_column_P_guess:
            x0 = np.log10(np.maximum(self.make_column_P_guess, tiny_sqrt))
            x, info = hybrd(fcn, x0, tol=self.tol_make_column)
        if info != 1:
            for scale in [1.0, 0.5, 2.0, 0.1, 5.0, 0.01]:
                x0 = np.log10(
                    np.maximum(N_i_surf * self.sp.gas_masses * grav * scale, tiny_sqrt)
                )
                x, info = hybrd(fcn, x0, tol=self.tol_make_column)
                if info == 1:
                    break
        if info != 1:
            raise ClimaException("hybrd root solve failed in make_column.")
        fcn(x)
        if err_box[0] is not None:
            raise ClimaException(err_box[0])
        self.make_column_P_guess = 10.0**x

    def make_profile_bg_gas(self, T_surf, P_i_surf, P_surf, bg_gas):
        """Background-gas constructor (clima_adiabat.f90:586-651)."""
        if P_surf <= 0:
            raise ClimaException("P_surf must be greater than zero.")
        if bg_gas not in self.species_names:
            raise ClimaException(f'Gas "{bg_gas}" is not in the list of species')
        ind = self.species_names.index(bg_gas)
        P_i = np.asarray(P_i_surf, dtype=np.float64).copy()
        err_box = [None]

        def fcn(x):
            P_i[ind] = 10.0 ** x[0]
            try:
                self.make_profile(T_surf, P_i)
            except ClimaException as e:
                err_box[0] = str(e)
                return np.array([1e30])
            err_box[0] = None
            return np.array([self.P_surf - P_surf])

        info = 0
        for scale in [1.0, 0.1]:
            x, info = hybrd(fcn, np.array([np.log10(P_surf * scale)]))
            if info == 1:
                break
        if info != 1:
            raise ClimaException("hybrd root solve failed in make_profile_bg_gas.")
        fcn(x)
        if err_box[0] is not None:
            raise ClimaException(err_box[0])

    def make_profile_dry(self, P, T, f_i):
        """Prescribed dry profile (clima_adiabat.f90:657-726)."""
        P = np.asarray(P, dtype=np.float64)
        T = np.asarray(T, dtype=np.float64)
        f_i = np.asarray(f_i, dtype=np.float64)
        if np.any(T < 0):
            raise ClimaException("`T` can not have negative elements")
        if np.any(P < 0):
            raise ClimaException("`P` can not have negative elements")
        if P[0] < self.P_top:
            raise ClimaException("The first element of `P` must be greater than `P_top`")
        if len(P) <= 1 or len(T) != len(P):
            raise ClimaException("`T` and `P` must have the same length > 1")
        if np.any(np.diff(P) >= 0):
            raise ClimaException("`P` must be strictly decreasing")
        if np.any(f_i < 0):
            raise ClimaException("`f_i` can not have negative elements")
        if f_i.shape != (len(P), self.sp.ng):
            raise ClimaException("`f_i` has the wrong shape")

        par = dataclasses.replace(self._par, P_top=float(self.P_top))
        t = self._tensor
        out = self._host(make_profile_dry_core(par, t(P[None]), t(T[None]), t(f_i[None])))
        self.N_surface = np.zeros(self.sp.ng)
        self.N_ocean = np.zeros((self.sp.ng, self.sp.ng))
        self.P_trop = -1.0

        self._finish_profile(out["T_e"][0], out)

        # intended(i) = lapse_rate_e(2i-2), i.e. the value at layer i-1's
        # center (clima_adiabat.f90:714-717): 0-based odd edge indices
        lr_e = out["lapse_rate_e"]
        self.lapse_rate_intended = np.concatenate([[lr_e[0]], lr_e[1::2][: self.nz - 1]])
        self._set_lapse_rates()

    # ------------------------------------------------------------------
    # radiative transfer wrappers
    # ------------------------------------------------------------------

    def copy_atm_to_radiative_grid(self):
        """Split each layer into two RT layers + 2 ghost layers (clima_adiabat.f90:729-773)."""
        if self.double_radiative_grid:
            rep = lambda a: np.repeat(a, 2, axis=0)
            ghost = lambda a: np.concatenate([rep(a), a[-1:], a[-1:]], axis=0)
            dz_half = 0.5 * self.dz
            return (ghost(self.T), ghost(self.P), ghost(self.densities), ghost(dz_half),
                    ghost(self.pdensities), ghost(self.pradii))
        return self.T, self.P, self.densities, self.dz, self.pdensities, self.pradii

    def _radiate_on_grid(self, T_surf, compute_solar=True, compute_opacity=True):
        T_r, P_r, dens_r, dz_r, pdens_r, prad_r = self.copy_atm_to_radiative_grid()
        if self.albedo_fcn is not None:
            self.rad.surface_albedo = np.full(self.rad.sol.nw, self.albedo_fcn(float(T_surf)))
        self.rad.radiate(
            T_surf, T_r, P_r / 1.0e6, dens_r, dz_r, pdens_r, prad_r,
            compute_solar=compute_solar, compute_opacity=compute_opacity,
        )
        top = self.nz_r
        ISR = float(self.rad.wrk_sol._fdn_n[top] - self.rad.wrk_sol._fup_n[top])
        OLR = -float(self.rad.wrk_ir._fdn_n[top] - self.rad.wrk_ir._fup_n[top])
        return ISR, OLR

    def TOA_fluxes(self, T_surf, P_i_surf):
        self.make_profile(T_surf, P_i_surf)
        return self._radiate_on_grid(T_surf)

    def TOA_fluxes_column(self, T_surf, N_i_surf):
        self.make_column(T_surf, N_i_surf)
        return self._radiate_on_grid(T_surf)

    def TOA_fluxes_bg_gas(self, T_surf, P_i_surf, P_surf, bg_gas):
        self.make_profile_bg_gas(T_surf, P_i_surf, P_surf, bg_gas)
        return self._radiate_on_grid(T_surf)

    def TOA_fluxes_dry(self, P, T, f_i):
        self.make_profile_dry(P, T, f_i)
        return self._radiate_on_grid(self.T_surf)

    # ------------------------------------------------------------------
    # surface temperature solvers (clima_adiabat.f90:882-1020)
    # ------------------------------------------------------------------

    def _bond_albedo(self):
        top = self.nz_r
        return float(self.rad.wrk_sol._fup_n[top] / self.rad.wrk_sol._fdn_n[top])

    def _simple_solver(self, toa_fcn, T_guess):
        err_box = [None]
        # Restore the make_column guess cache per evaluation, as the JAX
        # package does: TOA_fluxes_column's inner hybrd otherwise warm-starts
        # from the previous evaluation, making fcn(x) nondeterministic.
        P_guess0 = self.make_column_P_guess.copy()
        scale_box = [1.0]

        def fcn(x):
            self.make_column_P_guess = P_guess0.copy()
            T = 10.0 ** x[0]
            T_trop = 10.0 ** x[1] if self.solve_for_T_trop else self.T_trop
            try:
                self.T_trop = T_trop
                ISR, OLR = toa_fcn(T)
            except ClimaException as e:
                err_box[0] = str(e)
                return np.full(len(x), 1e30)
            err_box[0] = None
            scale_box[0] = max(abs(float(ISR)), abs(float(OLR)), 1.0)
            rad_enhancement = 1.0
            if self.tidally_locked_dayside:
                _, _, f_term = self.heat_redistribution_parameters()
                rad_enhancement = 4.0 * f_term
                self.rad.apply_radiation_enhancement(rad_enhancement)
            res = [ISR * rad_enhancement - OLR + self.surface_heat_flow]
            if self.solve_for_T_trop:
                stellar_radiation = self.rad.bolometric_flux()
                res.append(float(eqns.skin_temperature(stellar_radiation * rad_enhancement,
                                                       self._bond_albedo())) - T_trop)
            return np.array(res)

        if self.solve_for_T_trop:
            x0 = np.array([np.log10(T_guess), np.log10(self.T_trop)])
        else:
            x0 = np.array([np.log10(T_guess)])
        x, info = hybrd(fcn, x0)
        if info != 1:
            msg = "hybrd root solve failed."
            if err_box[0] is not None:
                msg += " " + err_box[0]
            raise ClimaException(msg)
        res = fcn(x)
        # The residual itself must be small against the flux scale: MINPACK's
        # xtol test also passes when the residual is flat in T_surf and the
        # iterates stop moving. This guard reproduces the JAX package's
        # (clima_tpu/adiabat/adiabat.py:567-583) as it stands, including its
        # known faults (ROADMAP Queue 3).
        if np.max(np.abs(res)) > 1.0e-2 * scale_box[0]:
            raise ClimaException(
                "surface_temperature root solve stalled: the TOA energy imbalance at "
                f"the returned point ({float(res[0]):.6g} mW/m^2) is not small against "
                f"the flux scale ({scale_box[0]:.6g} mW/m^2). The residual is likely "
                "flat in T_surf (e.g. an atmosphere opaque enough that TOA fluxes "
                "decouple from the surface); no radiative-equilibrium surface "
                "temperature exists to find."
            )
        return 10.0 ** x[0]

    def surface_temperature(self, P_i_surf, T_guess=280.0):
        P_i_surf = np.asarray(P_i_surf, dtype=np.float64)
        return self._simple_solver(lambda T: self.TOA_fluxes(T, P_i_surf), T_guess)

    def surface_temperature_column(self, N_i_surf, T_guess=280.0):
        N_i_surf = np.asarray(N_i_surf, dtype=np.float64)
        return self._simple_solver(lambda T: self.TOA_fluxes_column(T, N_i_surf), T_guess)

    def surface_temperature_bg_gas(self, P_i_surf, P_surf, bg_gas, T_guess=280.0):
        P_i_surf = np.asarray(P_i_surf, dtype=np.float64)
        return self._simple_solver(
            lambda T: self.TOA_fluxes_bg_gas(T, P_i_surf, P_surf, bg_gas), T_guess
        )

    # ------------------------------------------------------------------
    # particles / oceans
    # ------------------------------------------------------------------

    def set_particle_density_and_radii(self, P, pdensities, pradii):
        """Build particle interpolators in log10 space (clima_adiabat.f90:1047-1123)."""
        P = np.asarray(P, dtype=np.float64)
        pdensities = np.asarray(pdensities, dtype=np.float64)
        pradii = np.asarray(pradii, dtype=np.float64)
        if len(P) < 1:
            raise ClimaException("`P` must have a length greater than zero")
        if pdensities.shape != (len(P), self.sp.np_):
            raise ClimaException("`P` and `pdensities` have incompatible shapes")
        if pradii.shape != (len(P), self.sp.np_):
            raise ClimaException("`P` and `pradii` have incompatible shapes")
        if np.any(P <= 0):
            raise ClimaException("All elements of `P` must be larger than zero")
        if np.any(pdensities < 0):
            raise ClimaException("All elements of `pdensities` must be larger than zero")
        if np.any(pradii < 0):
            raise ClimaException("All elements of `pradii` must be larger than zero")

        tiny = 2.2250738585072014e-308
        big = 1.0e300
        self._particle_log10P = np.log10(np.concatenate([[tiny], P[::-1], [big]]))

        def pad(arr):
            a = np.concatenate([arr[-1:], arr[::-1], arr[:1]], axis=0)
            return np.log10(np.maximum(a, tiny))

        self._particle_log10_dens = pad(pdensities)
        self._particle_log10_radii = pad(pradii)

    def interpolate_particles(self, P):
        """Interpolate particle densities/radii to pressures P (clima_adiabat.f90:1022-1044)."""
        P = np.asarray(P, dtype=np.float64)
        if len(P) != self.nz:
            raise ClimaException("`P` has the wrong shape")
        if self.sp.np_ == 0:
            return
        lg = np.log10(P)
        for i in range(self.sp.np_):
            self.pdensities[:, i] = 10.0 ** np.interp(
                lg, self._particle_log10P, self._particle_log10_dens[:, i]
            )
            self.pradii[:, i] = 10.0 ** np.interp(
                lg, self._particle_log10P, self._particle_log10_radii[:, i]
            )

    def set_ocean_solubility_fcn(self, species, fcn):
        """Register a solubility callback fcn(T_surf, ng, P_i_bars, args) -> m_i."""
        if species not in self.species_names:
            raise ClimaException(f'Gas "{species}" is not in the list of species')
        self.ocean_fcns[self.species_names.index(species)] = fcn

    # ------------------------------------------------------------------
    # utilities
    # ------------------------------------------------------------------

    def to_regular_grid(self):
        """Regrid to equal-altitude layers (clima_adiabat.f90:1146-1214)."""
        nz = self.nz
        z_new, dz_new = eqns.vertical_grid(0.0, self.z[-1] + 0.5 * self.dz[-1], nz)
        ze = np.concatenate([[self.z[0] - 0.5 * self.dz[0]], self.z + 0.5 * self.dz])
        ze_new = np.concatenate([[z_new[0] - 0.5 * dz_new[0]], z_new + 0.5 * dz_new])
        densities_new = np.zeros_like(self.densities)
        for i in range(self.sp.ng):
            densities_new[:, i] = rebin(ze, self.densities[:, i], ze_new)
        T_new = np.interp(z_new, self.z, self.T)
        density_new = np.sum(densities_new, axis=1)
        self.f_i = densities_new / density_new[:, None]
        self.P = density_new * const.k_boltz * T_new
        self.T = T_new
        self.z = z_new
        self.dz = dz_new
        self.densities = densities_new

    def out2atmosphere_txt(self, filename, eddy, number_of_decimals=5,
                           overwrite=False, clip=True):
        """Write the atmosphere as a txt file (clima_adiabat.f90:1216-1317)."""
        self.to_regular_grid()
        eddy = np.asarray(eddy)
        if eddy.shape != (self.nz,):
            raise ClimaException('"eddy" has the wrong size')
        if number_of_decimals < 2 or number_of_decimals > 17:
            raise ClimaException('"number_of_decimals" should be between 1 and 17.')
        if not overwrite and os.path.exists(filename):
            raise ClimaException(
                f"Unable to create file {filename} because it already exists"
            )
        clip_value = 1.0e-40 if clip else -np.inf
        width = max(number_of_decimals + 9, max(len(n) for n in self.species_names) + 3)
        fmt = f"{{:<{width}.{number_of_decimals}e}}"
        lab = f"{{:<{width}}}"
        with open(filename, "w") as f:
            for h in ["alt", "press", "den", "temp", "eddy"] + self.species_names:
                f.write(lab.format(h))
            for i in range(self.nz):
                f.write("\n")
                f.write(fmt.format(self.z[i] / 1.0e5))
                f.write(fmt.format(self.P[i] / 1.0e6))
                f.write(fmt.format(np.sum(self.densities[i])))
                f.write(fmt.format(self.T[i]))
                f.write(fmt.format(eddy[i]))
                for j in range(self.sp.ng):
                    f.write(fmt.format(max(self.f_i[i, j], clip_value)))

    def heat_redistribution_parameters(self):
        """Koll (2022) tau_LW/k/f parameters (clima_adiabat.f90:1322-1395)."""
        Teq = self.rad.equilibrium_temperature(self._bond_albedo())
        grav = float(eqns.gravity(self.planet_radius, self.planet_mass, 0.0))
        mubar = float(self.f_i[0] @ self.sp.gas_masses)
        cp_i = heat_capacity(self.sp.thermo, torch.tensor(float(self.T_surf))).numpy()
        cp = float(np.sum(cp_i * self.f_i[0]))
        cp = cp * (1.0 / (mubar * 1.0e-3)) * 1.0e4  # J/mol/K -> erg/(g K)

        # Planck-weighted tau_LW (Koll 2020 Eq. 13)
        wavl = self.rad.ir.wavl
        freq = self.rad.ir.freq
        dlam = wavl[1:] - wavl[:-1]
        tau_lambda = np.sum(self.rad.wrk_ir.tau_band, axis=0)
        avg_freq = 0.5 * (freq[:-1] + freq[1:])
        avg_lam = const.c_light * 1.0e9 / avg_freq
        bplank = eqns.planck_fcn(torch.tensor(avg_freq), float(self.T_surf)).numpy()
        bplank = bplank * (avg_freq / avg_lam)
        numerator = np.sum(np.exp(-tau_lambda) * bplank * dlam)
        denominator = np.sum(bplank * dlam)
        tau_LW = -np.log(numerator / denominator)

        k_term = float(eqns.k_term_heat_redistribution(
            self.L, grav, self.chi, mubar, cp, self.n_LW, self.Cd))
        f_term = float(eqns.f_heat_redistribution(tau_LW, self.P_surf, Teq, k_term))
        return float(tau_LW), k_term, f_term
