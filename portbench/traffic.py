"""The one generator of the benchmark's traffic: it reads a mix's parameters
(``portbench/traffic/<name>.json``) and makes the columns of each batch call
on the device from the run's seed.

Two kinds of mix:

- ``prescribed_columns``: columns of the radiative-transfer chain. A base
  column (temperature with a lapse rate and a floor, pressure from a scale
  height or hydrostatic balance, mixing ratios constant or falling off with
  height or peaked in a layer, an optional haze of one particle layer) on
  the configuration's radiative layers; each column's temperatures and
  densities are the base's times a factor drawn uniformly in ``jitter``, and
  its surface temperature is drawn uniformly in ``T_surf_K``.
- ``surface_sweep``: columns of the adiabat column model, each a surface
  temperature drawn uniformly in ``T_surf_K`` and each gas's surface
  partial pressure a constant or drawn log-uniformly in a range.

Every mix holds ``columns_per_call`` and ``distinct_batches`` (batches made
in set-up and cycled through by the calls), and the answers its entry
compares with the reference: ``kept_columns_per_call`` (the radtran entry
keeps these of every call) or ``checked_columns`` (the adiabat entry draws
these from all the window's answers). The same seed gives the same columns;
every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["prescribed_columns", "surface_sweep", "generator"]

K_BOLTZ, N_AVO = 1.380649e-16, 6.02214076e23


def generator(seed, device, stream):
    """A torch generator on ``device`` for the seed and one of the run's
    streams of draws (0: the columns, 1: the kept answers)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % (1 << 63))


def _uniform(gen, shape, low, high, device, dtype):
    return low + (high - low) * torch.rand(shape, generator=gen, device=device, dtype=dtype)


def _base_column(col, gases, nz):
    """The base column on ``nz`` layers, ground-up: (T, P bar, densities
    (nz, ng), dz, z), float64 numpy."""
    top = float(col["top_cm"])
    if col["levels"] == "edges":  # layers at linspace(0, top, nz), each top / nz thick
        z = np.linspace(0.0, top, nz)
    else:  # layer centres of a uniform grid
        z = top / nz * (np.arange(nz) + 0.5)
    dz = np.full(nz, top / nz)
    T = np.maximum(col["T_surface_K"] - col["lapse_K_per_cm"] * z, col["T_min_K"])
    p = col["pressure"]
    if p["model"] == "scale_height":
        P = p["surface_bar"] * np.exp(-z / p["scale_height_cm"])
        den = P * 1.0e6 / (K_BOLTZ * T)
    else:  # hydrostatic on the layer grid at a constant gravity and mean molar mass
        T_mid = np.concatenate([T[:1], 0.5 * (T[1:] + T[:-1])])
        steps = np.concatenate([0.5 * dz[:1], dz[1:]])
        P = p["surface_bar"] * 1.0e6 * np.cumprod(
            np.exp(-(p["mubar"] * p["gravity_cm_s2"]) / (N_AVO * K_BOLTZ * T_mid) * steps))
        den = P / (K_BOLTZ * T)
        P = P / 1.0e6
    mix = np.full((nz, len(gases)), float(col["mixing_ratios"].get("default", 0.0)))
    rest = None
    for gas, m in col["mixing_ratios"].items():
        if gas == "default":
            continue
        if m == "rest":
            rest = gases.index(gas)
        elif isinstance(m, dict) and "peak" in m:  # a layer, as ozone's
            mix[:, gases.index(gas)] = m["peak"] * np.exp(-((z - m["peak_cm"]) / m["width_cm"]) ** 2)
        elif isinstance(m, dict):
            mix[:, gases.index(gas)] = m["surface"] * np.exp(-z / m["scale_height_cm"]) \
                + m.get("floor", 0.0)
        else:
            mix[:, gases.index(gas)] = m
    if rest is not None:
        others = np.delete(mix, rest, axis=1).sum(axis=1)
        mix[:, rest] = np.clip(1.0 - others, 0.0, 1.0)
    return T, P, mix * den[:, None], dz, z


def prescribed_columns(mix, gases, n_particles, nz, seed, device, dtype):
    """The ``distinct_batches`` batches of a ``prescribed_columns`` mix: a
    list of dicts of ground-up tensors T_surf (B,), T, P, dz (B, nz), dens
    (B, nz, ng) and, with a haze, pdens and radii (B, nz, np)."""
    T, P, dens, dz, z = _base_column(mix["column"], gases, nz)
    B, D = mix["columns_per_call"], mix["distinct_batches"]
    gen = generator(seed, device, 0)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    jitter = _uniform(gen, (D, B, 1), *mix["jitter"], device, dtype)
    T_surf = _uniform(gen, (D, B), *mix["T_surf_K"], device, dtype)
    haze = mix.get("haze")
    batches = []
    for d in range(D):
        b = dict(T_surf=T_surf[d], T=t(T)[None] * jitter[d], P=t(P).expand(B, nz).contiguous(),
                 dens=t(dens)[None] * jitter[d][:, :, None], dz=t(dz).expand(B, nz).contiguous())
        if haze is not None:
            pden = haze["density_cm3"] * np.exp(-((z - haze["peak_cm"]) / haze["width_cm"]) ** 2)
            b["pdens"] = t(np.repeat(pden[:, None], n_particles, 1)).expand(
                B, nz, n_particles).contiguous()
            b["radii"] = torch.full((B, nz, n_particles), haze["radius_cm"], dtype=dtype,
                                    device=device)
        batches.append(b)
    return batches


def surface_sweep(mix, gases, seed, device, dtype):
    """The ``distinct_batches`` batches of a ``surface_sweep`` mix: a list of
    (T_surf (B,) K, P_i_surf (B, ng) dyn/cm^2)."""
    B, D = mix["columns_per_call"], mix["distinct_batches"]
    gen = generator(seed, device, 0)
    T_surf = _uniform(gen, (D, B), *mix["T_surf_K"], device, dtype)
    pp = mix["partial_pressures_dyn_cm2"]
    P_i = torch.full((D, B, len(gases)), float(pp.get("default", 0.0)), dtype=dtype,
                     device=device)
    for gas, v in pp.items():
        if gas == "default":
            continue
        if isinstance(v, dict):
            lo, hi = np.log(v["loguniform"][0]), np.log(v["loguniform"][1])
            P_i[:, :, gases.index(gas)] = torch.exp(_uniform(gen, (D, B), lo, hi, device, dtype))
        else:
            P_i[:, :, gases.index(gas)] = float(v)
    return [(T_surf[d], P_i[d]) for d in range(D)]
