"""Frozen copy of the synthetic opacity database and template generator.

The real opacity database of Clima (photochem_clima_data) is not in the
repository, so every configuration runs on this synthetic template: a master
grid of 32 solar and 28 IR wavelength bins, 8 gauss points, smooth k-tables of
H2O, CO2 and CH4, CIA, Rayleigh, photolysis, Mie particles and an MT_CKD-like
water continuum. The generator is deterministic (no random numbers). This
copy is part of the benchmark's yardstick: the benchmark builds the template
with it and hands the same tree to the program under test and to the plain
reference, so a change to the program's own generator cannot move either
side. It needs numpy and yaml only.
"""

from __future__ import annotations

import numpy as np
import yaml

__all__ = ["synthetic_datadir", "star_table", "species_document", "SPECIES_YAML"]

C_LIGHT = 299792458.0
PLANK = 6.62607004e-34
K_BOLTZ_SI = 1.380649e-23

NGAUSS = 8


def _master_grid(nsol=32, nir=28):
    """Master wavelength edges (um) with solar and IR channel subranges.

    Solar spans 0.1-6 um; IR spans ~2-100 um; they overlap, sharing edges
    with the master grid exactly as the real bins.h5 does.
    """
    sol = np.geomspace(0.1, 6.0, nsol + 1)
    # first IR edge must exactly equal a solar edge: pick the one nearest 2 um
    i0 = int(np.argmin(np.abs(sol - 2.0)))
    ir_head = sol[i0:]
    n_extra = nir + 1 - len(ir_head)
    ir_tail = np.geomspace(6.0, 100.0, n_extra + 1)[1:]
    ir = np.concatenate([ir_head, ir_tail])
    master = np.concatenate([sol, ir_tail])
    return master, sol, ir


def _gauss_weights(n=NGAUSS):
    x, w = np.polynomial.legendre.leggauss(n)
    return w / w.sum()


def _band_profile(wl_um, centers, widths, depths):
    """Smooth synthetic absorption-band structure in log10 space."""
    out = np.zeros_like(wl_um)
    lw = np.log(wl_um)
    for c, s, d in zip(centers, widths, depths):
        out += d * np.exp(-0.5 * ((lw - np.log(c)) / s) ** 2)
    return out


_KBANDS = {
    "H2O": ([0.95, 1.14, 1.38, 1.87, 2.7, 6.3, 20.0, 60.0], [0.05, 0.05, 0.06, 0.07, 0.1, 0.25, 0.5, 0.5], [2.0, 2.2, 2.6, 3.0, 3.6, 4.5, 4.6, 4.2]),
    "CO2": ([1.4, 1.6, 2.0, 2.7, 4.3, 9.4, 10.4, 15.0], [0.03, 0.03, 0.04, 0.05, 0.06, 0.05, 0.05, 0.15], [1.5, 1.6, 2.0, 3.0, 5.0, 2.5, 2.5, 4.8]),
    "CH4": ([0.89, 1.14, 1.66, 2.3, 3.3, 7.7], [0.04, 0.04, 0.05, 0.06, 0.08, 0.12], [1.5, 1.8, 2.2, 2.8, 4.0, 4.2]),
    "O3": ([0.26, 0.6, 4.7, 9.6, 14.2], [0.1, 0.15, 0.05, 0.05, 0.08], [6.0, 1.5, 2.0, 4.0, 2.0]),
    "CO": ([1.57, 2.35, 4.67], [0.02, 0.03, 0.05], [1.0, 1.8, 3.5]),
    "O2": ([0.69, 0.76, 1.27, 6.4], [0.01, 0.01, 0.02, 0.3], [1.5, 2.0, 1.0, 0.6]),
}


def _ktable(wl_edges_um, species):
    wmid = np.sqrt(wl_edges_um[:-1] * wl_edges_um[1:])
    log10P = np.linspace(-8.0, 2.5, 9)  # log10(bar)
    T = np.linspace(80.0, 600.0, 7)
    centers, widths, depths = _KBANDS[species]
    base = -27.5 + _band_profile(wmid, centers, widths, depths)
    # gauss-point spread: k rises steeply at the last gauss points (line cores)
    gspread = np.linspace(-1.5, 2.5, NGAUSS)
    # mild pressure broadening and temperature dependence
    Pdep = 0.12 * (log10P - 0.0)
    Tdep = -0.3 * (T - 250.0) / 250.0
    log10k = (
        base[None, None, None, :]
        + gspread[:, None, None, None]
        + Pdep[None, :, None, None]
        + Tdep[None, None, :, None]
    )
    return {"weights": _gauss_weights(), "log10P": log10P, "T": T,
            "wavelengths": wl_edges_um, "log10k": log10k}


def _cia(pair):
    wl = np.geomspace(0.3, 100.0, 200)  # um, file's own grid
    T = np.linspace(100.0, 500.0, 5)
    base = {
        "N2-N2": -47.5,
        "H2-H2": -46.5,
        "CO2-CO2": -46.8,
        "N2-H2": -47.0,
        "O2-O2": -47.3,
    }.get(pair, -47.5)
    prof = base + _band_profile(wl, [4.2, 17.0, 60.0], [0.3, 0.4, 0.4], [1.0, 1.5, 1.2])
    Tdep = -0.2 * (T - 250.0) / 250.0
    return {"wavelengths": wl, "T": T, "log10xs": prof[None, :] + Tdep[:, None]}


def _continuum():
    wl = np.geomspace(0.5, 100.0, 300)
    T = np.linspace(150.0, 500.0, 6)
    prof = -46.0 + _band_profile(wl, [2.7, 6.3, 30.0], [0.2, 0.3, 0.6], [1.0, 2.0, 3.0])
    Tdep = -0.5 * (T - 296.0) / 296.0
    return {"wavelengths": wl, "T": T, "log10xs_H2O": prof[None, :] + Tdep[:, None],
            "log10xs_foreign": prof[None, :] - 1.5 + Tdep[:, None]}


def _photolysis(species):
    wl = np.geomspace(0.1, 1.0, 120) * 1.0e3  # nm
    cutoff = {"O3": 320.0, "O2": 240.0, "H2O": 200.0, "CO2": 200.0}.get(species, 220.0)
    xs = 1e-18 * np.exp(-((wl / cutoff) ** 4))
    return {"wavelengths": wl, "photoabsorption": np.maximum(xs, 1e-45)}


def _mie():
    wl = np.geomspace(0.1, 100.0, 150)  # um
    radii = np.geomspace(1e-3, 10.0, 40)  # um
    x = 2 * np.pi * radii[:, None] / wl[None, :]  # size parameter
    qext = 2.0 + 2.0 * np.exp(-x) * np.cos(x) - 2.0 * np.exp(-2 * x)
    qext = np.clip(qext, 1e-3, 4.0)
    w0 = 0.5 + 0.45 * (1 - np.exp(-x))
    g0 = 0.8 * (1 - np.exp(-0.5 * x))
    return {"wavelengths": wl, "radii": radii, "w0": w0, "qext": qext, "g0": g0}


_RAYLEIGH = {
    "H2O": dict(A=2.26e-4, B=4.57e-3, Delta=0.17),
    "CO2": dict(A=4.39e-4, B=6.4e-3, Delta=0.0805),
    "N2": dict(A=2.906e-4, B=7.7e-3, Delta=0.0305),
    "H2": dict(A=1.358e-4, B=7.52e-3, Delta=0.0221),
    "CH4": dict(A=4.398e-4, B=1.44e-2, Delta=0.0),
    "CO": dict(A=3.25e-4, B=8.0e-3, Delta=0.016),
    "O2": dict(A=2.663e-4, B=5.07e-3, Delta=0.054),
    "O3": dict(A=5.0e-4, B=1.0e-2, Delta=0.0),
}


def synthetic_datadir(k_species=("H2O", "CO2", "CH4"),
                      cia_pairs=("N2-N2", "CO2-CO2", "H2-H2"),
                      photolysis=("O3", "O2"),
                      particles=("khare1984",),
                      nsol=32, nir=28):
    """The synthetic opacity datadir in memory: {relative path: content}.

    ``.h5`` entries are dicts of numpy arrays, the ``.yaml`` entry its
    parsed document.
    """
    master, sol, ir = _master_grid(nsol, nir)
    tree = {"kdistributions/bins.h5": {"sol_wavl": sol, "ir_wavl": ir}}
    for sp in k_species:
        if sp not in _KBANDS:
            raise ValueError(f"no synthetic k-band recipe for {sp}")
        tree[f"kdistributions/{sp}.h5"] = _ktable(master, sp)
    for pair in cia_pairs:
        tree[f"CIA/{pair}.h5"] = _cia(pair)
    # key order as a YAML dump writes it (sorted): it sets the order of op.ray
    tree["rayleigh/rayleigh.yaml"] = {k: {"data": dict(v)} for k, v in sorted(_RAYLEIGH.items())}
    for sp in photolysis:
        tree[f"xsections/{sp}.h5"] = _photolysis(sp)
    tree["water_continuum/MT_CKD.h5"] = _continuum()
    for dat in particles:
        tree[f"aerosol_xsections/{dat}/mie_{dat}.h5"] = _mie()
    return tree




# NIST Shomate heat-capacity data (public physical constants)
SPECIES_YAML = """\
atoms:
- {name: H, mass: 1.00797}
- {name: N, mass: 14.0067}
- {name: O, mass: 15.9994}
- {name: C, mass: 12.011}

species:
- name: H2O
  composition: {H: 2, O: 1}
  thermo:
    model: Shomate
    temperature-ranges: [0.0, 1700.0, 6000.0]
    data:
    - [30.092, 6.832514, 6.793435, -2.53448, 0.082139, -250.881, 223.3967]
    - [41.96426, 8.622053, -1.49978, 0.098119, -11.15764, -272.1797, 219.7809]
  saturation:
    model: LinearLatentHeat
    parameters: {mu: 18.01534, T-ref: 373.15, P-ref: 1.0142e6, T-triple: 273.15,
      T-critical: 647.0}
    vaporization: {a: 2.841421e+10, b: -1.399732e+07}
    sublimation: {a: 2.746884e+10, b: 4.181527e+06}
    super-critical: {a: 1.793161e+12, b: 0.0}
- name: CO2
  composition: {C: 1, O: 2}
  thermo:
    model: Shomate
    temperature-ranges: [0.0, 1200.0, 6000.0]
    data:
    - [24.99735, 55.18696, -33.69137, 7.948387, -0.136638, -403.6075, 228.2431]
    - [58.16639, 2.720074, -0.492289, 0.038844, -6.447293, -425.9186, 263.6125]
  saturation:
    model: LinearLatentHeat
    parameters: {mu: 44.01, T-ref: 250.0, P-ref: 17843676.678142548, T-triple: 216.58,
      T-critical: 304.13}
    vaporization: {a: 4.656475e+09, b: -3.393595e+06}
    sublimation: {a: 6.564668e+09, b: -3.892217e+06}
    super-critical: {a: 1.635908e+11, b: 0.0}
- name: N2
  composition: {N: 2}
  thermo:
    model: Shomate
    temperature-ranges: [0.0, 6000.0]
    data:
    - [26.09, 8.22, -1.98, 0.16, 0.04, -7.99, 221.02]
- name: H2
  composition: {H: 2}
  thermo:
    model: Shomate
    temperature-ranges: [0.0, 1000.0, 2500.0, 6000.0]
    data:
    - [33.066178, -11.36342, 11.432816, -2.772874, -0.158558, -9.980797, 172.708]
    - [18.563083, 12.257357, -2.859786, 0.268238, 1.97799, -1.147438, 156.2881]
    - [43.41356, -4.293079, 1.272428, -0.096876, -20.53386, -38.51515, 162.0814]
- name: CH4
  composition: {C: 1, H: 4}
  thermo:
    model: Shomate
    temperature-ranges: [0.0, 1300.0, 6000.0]
    data:
    - [-0.703029, 108.4773, -42.52157, 5.862788, 0.678565, -76.84376, 158.7163]
    - [85.81217, 11.26467, -2.114146, 0.13819, -26.42221, -153.5327, 224.4143]
- name: CO
  composition: {C: 1, O: 1}
  thermo:
    model: Shomate
    temperature-ranges: [0.0, 1300.0, 6000.0]
    data:
    - [25.56759, 6.09613, 4.054656, -2.671301, 0.131021, -118.0089, 227.3665]
    - [35.1507, 1.300095, -0.205921, 0.01355, -3.28278, -127.8375, 231.712]
- name: O2
  composition: {O: 2}
  thermo:
    model: Shomate
    temperature-ranges: [0.0, 6000.0]
    data:
    - [29.659, 6.137261, -1.186521, 0.09578, -0.219663, -9.861391, 237.948]

particles:
- name: HCaer
  composition: {C: 4, H: 2}
"""




def star_table(Teff=5772.0, total_flux_wm2=1361.0):
    """Blackbody stellar spectrum scaled to the given bolometric flux.

    Columns: wavelength (nm), flux (mW/m^2/nm) — the reference star-file
    format — rounded to the 7 significant digits the star file holds.
    """
    wv_nm = np.geomspace(50.0, 2.0e5, 1500)
    wv_m = wv_nm * 1e-9
    h, c, kb = PLANK, C_LIGHT, K_BOLTZ_SI
    B = (2 * h * c**2 / wv_m**5) / (np.exp(h * c / (wv_m * kb * Teff)) - 1.0)  # W/m^3/sr
    flux = np.pi * B * 1e-9  # W/m^2/nm at the stellar surface
    total = np.trapezoid(flux, wv_nm)
    flux = flux * (total_flux_wm2 / total) * 1.0e3  # -> mW/m^2/nm at the planet
    return np.array([[float(f"{w:.6e}"), float(f"{fl:.6e}")] for w, fl in zip(wv_nm, flux)])




def species_document():
    """The template's species file as its parsed document."""
    return yaml.safe_load(SPECIES_YAML)
