"""Settings file parsing (settings.yaml).

Reference: ``src/clima_types.f90:17-59`` (ClimaSettings / SettingsOpacity) and
``src/clima_types_create.f90:517-1029``.

:func:`settings_from_dict` takes the parsed YAML document, so a caller that
already holds the content (the in-memory synthetic template) needs no YAML
parser; :func:`load_settings` reads a file and hands its document to it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..utils.errors import ClimaException

__all__ = ["ClimaSettings", "SettingsOpacity", "load_settings", "settings_from_dict"]


@dataclasses.dataclass
class SettingsOpacity:
    k_method: str = "RandomOverlapResortRebin"
    k_distributions: Optional[list] = None
    k_distributions_bool: Optional[bool] = None
    cia: Optional[list] = None
    cia_bool: Optional[bool] = None
    rayleigh: Optional[list] = None
    rayleigh_bool: Optional[bool] = None
    photolysis_xs: Optional[list] = None
    photolysis_bool: Optional[bool] = None
    water_continuum: Optional[str] = None
    particle_xs: Optional[list] = None  # list of {"name":..., "dat":...}


@dataclasses.dataclass
class ClimaSettings:
    filename: str = ""
    # atmosphere-grid
    atmos_grid_is_present: bool = False
    nz: Optional[int] = None
    bottom: Optional[float] = None
    top: Optional[float] = None
    # planet
    planet_is_present: bool = False
    planet_mass: Optional[float] = None
    planet_radius: Optional[float] = None
    surface_albedo: Optional[float] = None
    number_of_zenith_angles: Optional[int] = None
    P_surf: Optional[float] = None
    photon_scale_factor: float = 1.0
    # optical properties
    op: Optional[SettingsOpacity] = None
    gases: Optional[list] = None
    particles: Optional[list] = None
    wavelength_bins_file: Optional[str] = None


def _parse_opacities(opac: dict, settings_name: str) -> SettingsOpacity:
    sop = SettingsOpacity()

    def list_or_bool(key):
        v = opac.get(key)
        if v is None:
            return None, None
        if isinstance(v, bool):
            return None, v
        if isinstance(v, list):
            return [str(x) for x in v], None
        raise ClimaException(f'"{key}" in {settings_name} must be a list or boolean')

    sop.k_distributions, sop.k_distributions_bool = list_or_bool("k-distributions")
    sop.cia, sop.cia_bool = list_or_bool("CIA")
    sop.rayleigh, sop.rayleigh_bool = list_or_bool("rayleigh")
    sop.photolysis_xs, sop.photolysis_bool = list_or_bool("photolysis-xs")
    wc = opac.get("water-continuum")
    if wc is not None:
        sop.water_continuum = str(wc)
    pxs = opac.get("particle-xs")
    if pxs is not None:
        sop.particle_xs = [
            {"name": str(p["name"]), "dat": str(p["data"])} for p in pxs
        ]
    return sop


def load_settings(filename: str) -> ClimaSettings:
    import yaml

    with open(filename) as f:
        root = yaml.safe_load(f)
    return settings_from_dict(root, filename)


def settings_from_dict(root: dict, filename: str = "<settings>") -> ClimaSettings:
    """Build :class:`ClimaSettings` from a parsed settings.yaml document."""
    s = ClimaSettings(filename=filename)

    ag = root.get("atmosphere-grid")
    if ag is not None:
        s.atmos_grid_is_present = True
        s.nz = int(ag["number-of-layers"])
        if "bottom" in ag:
            s.bottom = float(ag["bottom"])
        if "top" in ag:
            s.top = float(ag["top"])

    pl = root.get("planet")
    if pl is not None:
        s.planet_is_present = True
        s.planet_mass = float(pl["planet-mass"])
        s.planet_radius = float(pl["planet-radius"])
        if s.planet_mass <= 0:
            raise ClimaException(f'"planet-mass" must be positive in {filename}')
        if s.planet_radius <= 0:
            raise ClimaException(f'"planet-radius" must be positive in {filename}')
        if "surface-albedo" in pl:
            s.surface_albedo = float(pl["surface-albedo"])
            if s.surface_albedo < 0:
                raise ClimaException(f'"surface-albedo" must be >= 0 in {filename}')
        if "number-of-zenith-angles" in pl:
            s.number_of_zenith_angles = int(pl["number-of-zenith-angles"])
            if s.number_of_zenith_angles < 1:
                raise ClimaException(
                    f'"number-of-zenith-angles" must be >= 1 in {filename}'
                )
        if "surface-pressure" in pl:
            s.P_surf = float(pl["surface-pressure"])
            if s.P_surf <= 0:
                raise ClimaException(f'"surface-pressure" must be positive in {filename}')
        s.photon_scale_factor = float(pl.get("photon-scale-factor", 1.0))

    op = root.get("optical-properties")
    if op is not None:
        spdict = op.get("species")
        if spdict is not None:
            if "gases" in spdict:
                s.gases = [str(x) for x in spdict["gases"]]
            if "particles" in spdict:
                s.particles = [str(x) for x in spdict["particles"]]
        k_method = op.get("k-method", "RandomOverlapResortRebin")
        if k_method not in ("RandomOverlapResortRebin", "AdaptiveEquivalentExtinction"):
            raise ClimaException(f'Unknown k-method "{k_method}" in {filename}')
        sop = _parse_opacities(op.get("opacities", {}), filename)
        sop.k_method = k_method
        s.op = sop
        wbf = op.get("wavelength-bins-file")
        if wbf is not None:
            s.wavelength_bins_file = str(wbf)

    return s
