"""Species file parsing (species.yaml).

Reference: ``src/clima_types.f90:109-150`` (Species = atoms + gases + particles)
and ``src/clima_types_create.f90:9-354`` (YAML parsing, Shomate/NASA9 thermo).

The per-gas thermodynamic polynomials are padded to a common number of
temperature ranges and stacked into arrays, so that heat-capacity evaluation
(`heat_capacity_eval`, clima_eqns.f90:105-133) is one gather + polynomial
over all gases, with no per-species branching. Each gas keeps its validated
LinearLatentHeat parameters as a plain dict (or None); the saturation model
stacks them (:meth:`..physics.saturation.SaturationParams.from_gas_list`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import constants as const
from ..utils.errors import ClimaException

SHOMATE = 0
NASA9 = 1

__all__ = ["Species", "GasThermo", "heat_capacity", "load_species", "species_from_dict"]


@dataclasses.dataclass(frozen=True)
class GasThermo:
    """Stacked thermodynamic data over all gases.

    temps: (ng, max_ranges+1) range edges, padded by repeating the last edge.
    coeffs: (ng, max_ranges, 9) polynomial coefficients (Shomate uses 7).
    model: (ng,) int, SHOMATE or NASA9.
    poly: (ng*max_ranges, 7) tensor tables only (:meth:`to`): each range's
    heat capacity as one polynomial in [T^-2, T^-1, 1, T, T^2, T^3, T^4],
    J/(mol K); None on the host. base: (ng,) row of each gas's first range
    in ``poly`` (tensor tables only).
    """

    temps: np.ndarray
    coeffs: np.ndarray
    model: np.ndarray
    poly: Optional[torch.Tensor] = None
    base: Optional[torch.Tensor] = None

    def to(self, device, dtype=torch.float64) -> "GasThermo":
        """The same tables as tensors on ``device`` (temps/coeffs in ``dtype``)."""
        c = np.asarray(self.coeffs, dtype=np.float64)
        shomate = np.stack([c[..., 4] * 1.0e6, np.zeros_like(c[..., 0]), c[..., 0],
                            c[..., 1] / 1.0e3, c[..., 2] / 1.0e6, c[..., 3] / 1.0e9,
                            np.zeros_like(c[..., 0])], axis=-1)
        nasa9 = const.Rgas_si * c[..., :7]
        poly = np.where((np.asarray(self.model) == SHOMATE)[:, None, None], shomate, nasa9)
        t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
        ng, n_ranges = c.shape[:2]
        return GasThermo(t(self.temps, dtype), t(self.coeffs, dtype), t(self.model, torch.int32),
                         t(poly.reshape(-1, 7), dtype), t(np.arange(ng) * n_ranges, torch.long))


def heat_capacity(thermo: GasThermo, T):
    """Heat capacity of every gas at temperature T, J/(mol K).

    ``T`` (...) tensor, one temperature per entry; returns (..., ng).
    ``thermo`` holds tensors on T's device (:meth:`GasThermo.to`); numpy
    tables are moved there on the fly. Each gas's Shomate or NASA-9
    polynomial (eqns.heat_capacity_shomate / _nasa9, clima_eqns.f90:82-103)
    is evaluated as one polynomial in powers of T. Out-of-range temperatures
    return NaN: the reference's heat_capacity_eval reports "not found"
    outside the tables' ranges and every caller turns that into a hard error
    (clima_eqns.f90:105-133), which keeps solver trial steps inside physical
    territory. The NaN propagates to the facade, whose finiteness checks
    raise ClimaException.
    """
    if not torch.is_tensor(T):
        T = torch.tensor(T, dtype=torch.float64)
    if thermo.poly is None:
        thermo = thermo.to(T.device, T.dtype)
    temps = thermo.temps
    n_ranges = temps.shape[1] - 1
    Tx = T[..., None]  # (..., 1) against (ng,)
    idx = torch.sum(Tx[..., None] >= temps[:, :-1], dim=-1) - 1
    flat = torch.clamp(idx, 0, n_ranges - 1) + thermo.base
    inv = 1.0 / Tx
    T2 = Tx * Tx
    powers = torch.cat([inv * inv, inv, torch.ones_like(Tx), Tx, T2, T2 * Tx, T2 * T2], dim=-1)
    cp = torch.sum(thermo.poly[flat] * powers[..., None, :], dim=-1)
    in_range = (Tx >= temps[:, 0]) & (Tx < temps[:, -1])
    return cp.masked_fill(~in_range, torch.nan)


@dataclasses.dataclass
class Species:
    """Host-side species database (atoms, gases, particles)."""

    atom_names: list
    atom_masses: np.ndarray
    gas_names: list
    gas_masses: np.ndarray  # (ng,) g/mol
    thermo: GasThermo
    sat: list  # per gas: dict of LinearLatentHeat parameters, or None
    particle_names: list
    particle_compositions: list

    @property
    def ng(self):
        return len(self.gas_names)

    @property
    def np_(self):
        return len(self.particle_names)


def _parse_thermo(th: dict, name: str) -> tuple:
    model_name = th.get("model")
    if model_name == "Shomate":
        model = SHOMATE
        ncoef = 7
    elif model_name in ("NASA9", "Nasa9"):
        model = NASA9
        ncoef = 9
    else:
        raise ClimaException(
            f'"{model_name}" thermodynamic model for {name} is not supported'
        )
    temps = np.asarray(th["temperature-ranges"], dtype=np.float64)
    data = [np.asarray(d, dtype=np.float64) for d in th["data"]]
    if len(data) != len(temps) - 1:
        raise ClimaException(f"thermo data/temperature-ranges mismatch for {name}")
    for d in data:
        if len(d) != ncoef:
            raise ClimaException(f"wrong number of thermo coefficients for {name}")
    return model, temps, data


def _parse_sat(s: Optional[dict], name: str, filename: str) -> Optional[dict]:
    if s is None:
        return None
    if s.get("model") != "LinearLatentHeat":
        raise ClimaException(
            f'Saturation "model" must be "LinearLatentHeat" for species "{name}" in {filename}'
        )
    p = s["parameters"]
    out = dict(
        mu=float(p["mu"]),
        T_ref=float(p["T-ref"]),
        P_ref=float(p["P-ref"]),
        T_triple=float(p["T-triple"]),
        T_critical=float(p["T-critical"]),
        a_v=float(s["vaporization"]["a"]),
        b_v=float(s["vaporization"]["b"]),
        a_s=float(s["sublimation"]["a"]),
        b_s=float(s["sublimation"]["b"]),
        a_c=float(s["super-critical"]["a"]),
        b_c=float(s["super-critical"]["b"]),
    )
    if out["mu"] <= 0 or out["T_ref"] <= 0 or out["P_ref"] <= 0:
        raise ClimaException(f'Invalid saturation parameters for "{name}" in {filename}')
    if not (out["T_triple"] < out["T_ref"] < out["T_critical"]):
        raise ClimaException(
            f'Saturation "T-ref" must be within (T-triple, T-critical) for "{name}" in {filename}'
        )
    return out


def load_species(filename: str) -> Species:
    """Parse a species.yaml file (clima_types_create.f90:9-236)."""
    import yaml

    with open(filename) as f:
        root = yaml.safe_load(f)
    return species_from_dict(root, filename)


def species_from_dict(root: dict, filename: str = "<species>") -> Species:
    """Build :class:`Species` from a parsed species.yaml document."""
    atoms = root.get("atoms", [])
    atom_names = [a["name"] for a in atoms]
    atom_masses = np.array([float(a["mass"]) for a in atoms])
    atom_mass_map = dict(zip(atom_names, atom_masses))

    gas_names = []
    gas_masses = []
    thermos = []
    sats = []
    for g in root.get("species", []):
        name = g["name"]
        comp = g.get("composition", {})
        mass = 0.0
        for at, ct in comp.items():
            if at not in atom_mass_map:
                raise ClimaException(f'Atom "{at}" of species "{name}" not in atoms list')
            mass += atom_mass_map[at] * ct
        if "thermo" not in g:
            raise ClimaException(f'Species "{name}" is missing thermodynamic data')
        gas_names.append(name)
        gas_masses.append(mass)
        thermos.append(_parse_thermo(g["thermo"], name))
        sats.append(_parse_sat(g.get("saturation"), name, filename))

    if len(gas_names) == 0:
        raise ClimaException(f"No species found in {filename}")

    # stack thermo, padding ranges
    max_r = max(len(t[2]) for t in thermos)
    ng = len(gas_names)
    temps = np.zeros((ng, max_r + 1))
    coeffs = np.zeros((ng, max_r, 9))
    model = np.zeros(ng, dtype=np.int32)
    for i, (m, tr, data) in enumerate(thermos):
        model[i] = m
        nr = len(data)
        temps[i, : nr + 1] = tr
        temps[i, nr + 1 :] = tr[-1]
        for r in range(max_r):
            d = data[min(r, nr - 1)]
            coeffs[i, r, : len(d)] = d

    particles = root.get("particles", []) or []
    particle_names = [p["name"] for p in particles]
    particle_comps = [p.get("composition", {}) for p in particles]

    return Species(
        atom_names=atom_names,
        atom_masses=atom_masses,
        gas_names=gas_names,
        gas_masses=np.array(gas_masses),
        thermo=GasThermo(temps, coeffs, model),
        sat=sats,
        particle_names=particle_names,
        particle_compositions=particle_comps,
    )
