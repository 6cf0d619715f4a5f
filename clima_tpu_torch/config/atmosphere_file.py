"""Atmosphere column text files (alt/press/den/temp/eddy + mixing ratios).

Reference: ``src/clima_types.f90:73-90`` and ``src/clima_types_create.f90:
356-515`` (`AtmosphereFile`, `unpack_atmospherefile`). Host numpy, as in the
JAX package (``clima_tpu/config/atmosphere_file.py``), of which this is the
port's own copy.
"""

from __future__ import annotations

import numpy as np

from ..utils.errors import ClimaException

__all__ = ["AtmosphereFile", "unpack_atmospherefile"]


class AtmosphereFile:
    """A whitespace-separated table: one header line of labels, then one row
    per altitude (alt in km, press in bar, den, temp, eddy and one column of
    mixing ratio per species)."""

    def __init__(self, filename: str):
        with open(filename) as f:
            header = f.readline().split()
        if len(header) == 0:
            raise ClimaException(f"{filename} has no header")
        data = np.loadtxt(filename, skiprows=1)
        if data.ndim == 1:
            data = data[None, :]
        if data.shape[1] != len(header):
            raise ClimaException(f"{filename} has inconsistent columns")
        self.labels = header
        self.columns = {lab: data[:, i] for i, lab in enumerate(header)}
        self.nz = data.shape[0]

    def get(self, label):
        if label not in self.columns:
            raise ClimaException(f'"{label}" not found in atmosphere file')
        return self.columns[label]


def unpack_atmospherefile(atm: AtmosphereFile, species_names, z):
    """Interpolate an atmosphere file onto grid-center altitudes z (cm).

    Returns (mix (nz, ng), T (nz,), P (nz, dynes/cm^2)). Mirrors
    ``unpack_atmospherefile`` (clima_types_create.f90:356-515): linear
    interpolation in altitude (of log P for the pressure), constant
    extrapolation at the ends; mixing ratios are normalized to sum to 1.
    """
    z_file = atm.get("alt") * 1.0e5  # km -> cm
    T_file = atm.get("temp")
    P_file = atm.get("press") * 1.0e6  # bar -> dynes/cm^2

    def interp(vals):
        return np.interp(z, z_file, vals)

    T = interp(T_file)
    P = np.exp(np.interp(z, z_file, np.log(P_file)))
    ng = len(species_names)
    mix = np.zeros((len(z), ng))
    for i, name in enumerate(species_names):
        mix[:, i] = interp(atm.get(name))
    mix = mix / np.sum(mix, axis=1, keepdims=True)
    return mix, T, P
