"""The Radtran facade: IR + solar radiative transfer on a fixed column grid.

Mirrors the public surface of the reference ``Radtran`` class
(``src/radtran/clima_radtran.f90:31-91`` and the Cython wrapper
``clima/cython/Radtran.pyx``): constructors from settings.yaml, ``radiate``,
``TOA_fluxes``, bolometric-flux helpers, custom optical properties, and the
``wrk_ir``/``wrk_sol`` result views.

The opacity tables live on ``device`` in ``dtype`` from construction on;
results stay there and are copied to numpy lazily through the
ClimaRadtranWrk properties. One column is a batch of one in the batched
functions of :mod:`.opacity` and :mod:`.radiate`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import load_settings
from ..physics import eqns
from ..utils.device import resolve_device
from ..utils.errors import ClimaException
from . import data as data_mod
from .opacity import compute_opacity as _compute_opacity  # radiate() has an argument of that name
from .radiate import radiate_ir, radiate_solar, integrate_fluxes

__all__ = ["Radtran", "ClimaRadtranWrk", "RTChannelView"]


def _np(x):
    return x.detach().cpu().numpy()


class ClimaRadtranWrk:
    """Result container (reference ClimaRadtranWrk, clima_radtran.f90:11-25).

    Arrays are ground-up: index 0 of the edge axis is the surface.
    """

    def __init__(self, nz, nw, device, dtype):
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        self._fup_a = z(nz + 1, nw)
        self._fdn_a = z(nz + 1, nw)
        self._fup_n = z(nz + 1)
        self._fdn_n = z(nz + 1)
        self._amean = z(nz + 1, nw)
        self._tau_band = z(nz, nw)

    fup_a = property(lambda self: _np(self._fup_a))
    fdn_a = property(lambda self: _np(self._fdn_a))
    fup_n = property(lambda self: _np(self._fup_n))
    fdn_n = property(lambda self: _np(self._fdn_n))
    amean = property(lambda self: _np(self._amean))
    tau_band = property(lambda self: _np(self._tau_band))


class RTChannelView:
    """Wavelength-channel metadata view (reference RTChannel) of a
    ``data.ChannelInfo``, such as ``Radtran.ir`` or ``Radtran.sol``: its
    wavelength and frequency edges as numpy arrays and its bin count."""

    def __init__(self, info):
        self._info = info

    @property
    def wavl(self):
        return np.asarray(self._info.wavl)

    @property
    def freq(self):
        return np.asarray(self._info.freq)

    @property
    def nw(self):
        return self._info.nw


class Radtran:
    """IR and solar radiative transfer (reference Radtran facade)."""

    def __init__(self, species_names, particle_names, settings, star_f,
                 num_zenith_angles, surface_albedo, nz, datadir,
                 device=None, dtype=torch.float64):
        """Equivalent of create_Radtran_2 (clima_radtran.f90:128-219).

        ``settings`` may be a ClimaSettings object or a settings.yaml path;
        ``star_f`` a star file path or its (n, 2) table; ``datadir`` a path
        or an in-memory data tree (:class:`.data.DataDir`). ``device`` None
        means the CUDA card (raises without one); pass "cpu" for the CPU.
        """
        s = load_settings(settings) if isinstance(settings, str) else settings

        if nz < 1:
            raise ClimaException('"nz" can not be less than 1.')
        self.device = resolve_device(device)
        self.dtype = dtype
        self.ng = len(species_names)
        self.species_names = list(species_names)
        self.np = len(particle_names)
        self.particle_names = list(particle_names)
        self.nz = nz

        ang, w = eqns.zenith_angles_and_weights(num_zenith_angles)
        self.zenith_u = np.cos(ang * np.pi / 180.0)
        self.zenith_weights = w

        if s.op is None:
            raise ClimaException(
                f'"{s.filename}/optical-properties" does not contain opacity information.'
            )
        self.op = data_mod.load_optical_data(datadir, species_names, particle_names, s.op,
                                             device=self.device, dtype=dtype)
        self.ir = data_mod.load_channel(datadir, "ir", s.wavelength_bins_file, self.op)
        self.sol = data_mod.load_channel(datadir, "solar", s.wavelength_bins_file, self.op)

        self.surface_albedo = np.full(self.sol.nw, surface_albedo, dtype=np.float64)
        self.surface_emissivity = np.ones(self.ir.nw, dtype=np.float64)
        self.has_hard_surface = True
        self.ir_tau_min = 1.0e-6
        self.diurnal_fac = 0.5
        self.photon_scale_factor = (
            s.photon_scale_factor if s.planet_is_present else 1.0
        )
        self.photons_sol = data_mod.read_stellar_flux(star_f, self.sol.wavl)

        self.wrk_ir = ClimaRadtranWrk(nz, self.ir.nw, self.device, dtype)
        self.wrk_sol = ClimaRadtranWrk(nz, self.sol.nw, self.device, dtype)
        self.f_total = np.zeros(nz + 1)

        self._custom = None
        self._opr = None  # last computed opacity (device dict, batch of one)

    @classmethod
    def from_settings(cls, settings_f, star_f, num_zenith_angles, surface_albedo, nz,
                      datadir, device=None, dtype=torch.float64):
        """Equivalent of create_Radtran_1 (clima_radtran.f90:98-126).

        ``settings_f`` is a settings.yaml path or a ClimaSettings object."""
        s = load_settings(settings_f) if isinstance(settings_f, str) else settings_f
        if s.gases is None:
            raise ClimaException(
                f'"{s.filename}/optical-properties/gases" does not exist'
            )
        particles = s.particles or []
        return cls(s.gases, particles, s, star_f, num_zenith_angles, surface_albedo, nz,
                   datadir, device=device, dtype=dtype)

    # ------------------------------------------------------------------
    # main entry points
    # ------------------------------------------------------------------

    def _t(self, x):
        """A host array as a batch-of-one tensor on the model's device."""
        return torch.as_tensor(np.array(x, dtype=np.float64), dtype=self.dtype,
                               device=self.device)[None]

    def _check_inputs(self, T, P, densities, dz, pdensities, radii):
        nz, ng, np_ = self.nz, self.ng, self.np
        if (pdensities is None) != (radii is None):
            raise ClimaException("Both pdensities and radii must be arguments.")
        if np_ > 0 and radii is None:
            raise ClimaException(
                'The model contains particles but "pdensities" and "radii" are not arguments.'
            )
        if np.shape(T) != (nz,):
            raise ClimaException('"T" has the wrong input dimension.')
        if np.shape(P) != (nz,):
            raise ClimaException('"P" has the wrong input dimension.')
        if np.shape(densities) != (nz, ng):
            raise ClimaException('"densities" has the wrong input dimension.')
        if np.shape(dz) != (nz,):
            raise ClimaException('"dz" has the wrong input dimension.')
        if radii is not None:
            if np.shape(pdensities) != (nz, np_):
                raise ClimaException('"pdensities" has the wrong input dimension.')
            if np.shape(radii) != (nz, np_):
                raise ClimaException('"radii" has the wrong input dimension.')

    def radiate(self, T_surface, T, P, densities, dz, pdensities=None, radii=None,
                compute_solar=True, compute_opacity=True):
        """Full RT evaluation (Radtran_radiate, clima_radtran.f90:221-318).

        Inputs are ground-up: T (nz,), P (nz,) bars, densities (nz, ng)
        molecules/cm^3, dz (nz,) cm. Results are stored on wrk_ir / wrk_sol /
        f_total, ground-up.
        """
        self._check_inputs(T, P, densities, dz, pdensities, radii)
        has_particles = radii is not None and self.np > 0
        op = self.op
        T_t = self._t(T)

        if compute_opacity or self._opr is None:
            self._opr = _compute_opacity(
                op, self._t(P), T_t, self._t(densities), self._t(dz),
                self._t(pdensities) if has_particles else None,
                self._t(radii) if has_particles else None,
                self._custom,
            )

        self._store(self.wrk_ir, self._ir_fn(self._opr, self._t(T_surface), T_t))

        if compute_solar:
            sol_slice = (self.sol.ind_start, self.sol.ind_end)
            sol_res = radiate_solar(
                sol_slice, op.freq, op.wavl, op.kset.wbin, self._opr,
                self._t(self.surface_albedo)[0], self.diurnal_fac,
                self._t(self.photons_sol * self.photon_scale_factor)[0],
                self._t(self.zenith_u)[0], self._t(self.zenith_weights)[0],
            )
            sol_res["fup_n"], sol_res["fdn_n"] = integrate_fluxes(
                sol_res["fup_a"], sol_res["fdn_a"], op.freq[sol_slice[0] : sol_slice[1] + 2])
            self._store(self.wrk_sol, sol_res)

        self._set_f_total()

    def _ir_fn(self, opr, T_surface, T):
        """IR radiative transfer of a batch of columns on the opacities ``opr``
        (each of its tensors with a leading column axis of the batch's size,
        or of 1 to share one column's opacities): T_surface (B,), T (B, nz)
        ground-up. Returns radiate_ir's dict plus the frequency-integrated
        ``fup_n``/``fdn_n`` (B, nz+1)."""
        op = self.op
        i0, i1 = self.ir.ind_start, self.ir.ind_end
        B = T.shape[0]
        opr = {k: v.expand(B, *v.shape[1:]) for k, v in opr.items()}
        res = radiate_ir((i0, i1), op.freq, op.kset.wbin, opr,
                         self._t(self.surface_emissivity)[0], self.has_hard_surface,
                         self.ir_tau_min, T_surface, T)
        res["fup_n"], res["fdn_n"] = integrate_fluxes(res["fup_a"], res["fdn_a"],
                                                      op.freq[i0 : i1 + 2])
        return res

    def ir_fluxes_batch(self, T_surface, T):
        """IR fluxes of a batch of temperature columns on the opacities of the
        last :meth:`radiate` call (frozen): T_surface (B,), T (B, nz)
        ground-up, host arrays. Returns (fup_n, fdn_n), (B, nz+1) tensors on
        the model's device, mW/m^2. The RCE finite-difference Jacobian runs
        its column perturbations through this one call."""
        if self._opr is None:
            raise ClimaException("ir_fluxes_batch needs the opacities of a radiate call")
        res = self._ir_fn(self._opr, self._t(T_surface)[0], self._t(T)[0])
        return res["fup_n"], res["fdn_n"]

    @staticmethod
    def _store(w, res):
        w._fup_a, w._fdn_a = res["fup_a"][0], res["fdn_a"][0]
        w._fup_n, w._fdn_n = res["fup_n"][0], res["fdn_n"][0]
        w._amean = res["amean"][0]
        w._tau_band = res["tau_band"][0]

    def _set_f_total(self):
        self.f_total = _np(
            (self.wrk_sol._fdn_n - self.wrk_sol._fup_n)
            + (self.wrk_ir._fdn_n - self.wrk_ir._fup_n)
        )

    def TOA_fluxes(self, T_surface, T, P, densities, dz, pdensities=None, radii=None,
                   compute_solar=True, compute_opacity=True):
        """Returns (ISR, OLR) in mW/m^2 (clima_radtran.f90:320-342)."""
        self.radiate(T_surface, T, P, densities, dz, pdensities, radii,
                     compute_solar, compute_opacity)
        ISR = float(self.wrk_sol._fdn_n[self.nz] - self.wrk_sol._fup_n[self.nz])
        OLR = -float(self.wrk_ir._fdn_n[self.nz] - self.wrk_ir._fup_n[self.nz])
        return ISR, OLR

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def bolometric_flux(self):
        """Bolometric stellar flux at the planet, W/m^2 (clima_radtran.f90:353-364)."""
        dfreq = self.sol.freq[:-1] - self.sol.freq[1:]
        return float(np.sum(self.photons_sol * dfreq) * self.photon_scale_factor / 1.0e3)

    def set_bolometric_flux(self, flux):
        self.photon_scale_factor = 1.0
        self.photon_scale_factor = flux / self.bolometric_flux()

    def skin_temperature(self, bond_albedo):
        return float(eqns.skin_temperature(self.bolometric_flux(), bond_albedo))

    def equilibrium_temperature(self, bond_albedo):
        return float(eqns.equilibrium_temperature(self.bolometric_flux(), bond_albedo))

    def apply_radiation_enhancement(self, rad_enhancement):
        """Scale solar fluxes (tidally-locked dayside, clima_radtran.f90:402-411)."""
        w = self.wrk_sol
        w._fdn_n = w._fdn_n * rad_enhancement
        w._fdn_a = w._fdn_a * rad_enhancement
        w._fup_n = w._fup_n * rad_enhancement
        w._fup_a = w._fup_a * rad_enhancement
        self._set_f_total()

    def opacities2yaml(self):
        return "optical-properties:\n" + self.op.opacities2yaml()

    def set_custom_optical_properties(self, wv, P, dtau_dz, w0, g0):
        """Inject custom opacity (clima_radtran.f90:493-506, types.f90:429-533).

        wv (nwv,) nm; P (nP,) dynes/cm^2 decreasing; dtau_dz/w0/g0 (nP, nwv).
        """
        wv = np.asarray(wv, dtype=np.float64)
        P = np.asarray(P, dtype=np.float64)
        dtau_dz = np.asarray(dtau_dz, dtype=np.float64)
        w0 = np.asarray(w0, dtype=np.float64)
        g0 = np.asarray(g0, dtype=np.float64)
        if np.any(wv <= 0):
            raise ClimaException("All elements of `wv` must be larger than zero")
        if np.any(P <= 0):
            raise ClimaException("All elements of `P` must be larger than zero")
        for arr, name in ((dtau_dz, "dtau_dz"), (w0, "w0"), (g0, "g0")):
            if arr.shape != (len(P), len(wv)):
                raise ClimaException(f"`P`/`wv` and `{name}` have incompatible shapes")
        wavl = _np(self.op.wavl)
        wv1 = 0.5 * (wavl[1:] + wavl[:-1])  # median wavelengths

        def regrid(arr):
            out = np.zeros((len(P), self.op.nw))
            for i in range(len(P)):
                out[i] = np.interp(wv1, wv, arr[i])
            return out[::-1]  # ascending log10P ordering

        self._custom = {
            "log10P": self._t(np.log10(P)[::-1])[0],
            "dtau_dz": self._t(regrid(dtau_dz))[0],
            "w0": self._t(regrid(w0))[0],
            "g0": self._t(regrid(g0))[0],
        }
        self._opr = None

    def unset_custom_optical_properties(self):
        self._custom = None
        self._opr = None

