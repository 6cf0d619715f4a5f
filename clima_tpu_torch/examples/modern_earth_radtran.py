"""Standalone Radtran on a ModernEarth-like column (the port of the JAX
package's ``examples/modern_earth_radtran.py``).

Mirrors the reference's ``tests/test_radtran.f90`` workflow: build a
`Radtran` with an explicit gas and particle list and 8 zenith angles, call
`radiate` on a prescribed column with particles, print the TOA solar
downward flux, dump the TOA spectra to ``root``, print `opacities2yaml`, and
round-trip custom optical properties (clima_radtran.f90:221-512). The
synthetic opacity database is built in memory (``data.make_template``).

    python -m clima_tpu_torch.examples.modern_earth_radtran

runs on the CUDA card; ``main(device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import yaml

from ..config import settings_from_dict
from ..data import make_template
from ..physics import eqns
from ..radtran import Radtran
from ..utils.device import resolve_device

N_ZENITH = 8

SETTINGS = """\
atmosphere-grid:
  bottom: 0.0
  top: 0.7e7
  number-of-layers: {nz}

planet:
  surface-pressure: 1.013
  planet-mass: 5.972e27
  planet-radius: 6.371e8
  surface-albedo: 0.15
  number-of-zenith-angles: {n_zenith}

optical-properties:
  species:
    gases: [H2O, CO2, O2, N2, CH4]
    particles: [HCaer]
  k-method: RandomOverlapResortRebin
  opacities: {{k-distributions: true, CIA: true, rayleigh: true, photolysis-xs: true,
    water-continuum: MT_CKD, particle-xs: [{{name: HCaer, data: khare1984}}]}}
"""


def settings_text(nz=50, n_zenith=N_ZENITH):
    """The example's settings.yaml (five gases, the HCaer haze)."""
    return SETTINGS.format(nz=nz, n_zenith=n_zenith)


def build_radtran(nz=50, device=None):
    """``Radtran.from_settings`` on the in-memory template: 8 zenith angles,
    surface albedo 0.15, ``nz`` layers."""
    t = make_template(nz=nz, n_zenith=N_ZENITH, particles=True)
    s = settings_from_dict(yaml.safe_load(settings_text(nz)), "<settings_me>")
    return Radtran.from_settings(s, t["star"], num_zenith_angles=N_ZENITH, surface_albedo=0.15,
                                 nz=nz, datadir=t["datadir"], device=device)


def earth_column(nz=50, ng=5, T_surf=288.0):
    """A ModernEarth-like column (ground-up) with a thin haze peaked aloft:
    (T_surf, T, P bar, densities, dz, pdensities, radii)."""
    z, dz = eqns.vertical_grid(0.0, 0.7e7, nz)
    T = np.maximum(T_surf - 6.5e-5 * z, 200.0)
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))
    P, den = (x.numpy() for x in eqns.press_and_den(t(T), t(np.full(nz, 981.0)), 1.013e6,
                                                   t(dz), t(np.full(nz, 28.6))))
    mix = np.zeros((nz, ng))
    mix[:, 0] = 1e-2 * np.exp(-z / 2e5)      # H2O
    mix[:, 1] = 400e-6                        # CO2
    mix[:, 2] = 0.21                          # O2
    mix[:, 4] = 1.8e-6                        # CH4
    mix[:, 3] = np.clip(1.0 - mix[:, [0, 1, 2, 4]].sum(1), 0.0, 1.0)  # N2
    densities = mix * den[:, None]
    pdensities = (1.0e-2 * np.exp(-((z - 4e6) / 1e6) ** 2))[:, None]
    radii = np.full((nz, 1), 1.0e-5)
    return T_surf, T, P / 1.0e6, densities, dz, pdensities, radii


def main(device=None, nz=50, root=None):
    """Run the example; returns its printed numbers and the spectra file."""
    resolve_device(device)
    root = root or tempfile.mkdtemp(prefix="clima_tpu_torch_modern_earth_")
    rad = build_radtran(nz, device)
    T_surf, T, P, densities, dz, pdensities, radii = earth_column(nz)

    rad.radiate(T_surf, T, P, densities, dz, pdensities=pdensities, radii=radii)
    f0 = float(rad.f_total[0])
    out = dict(toa_solar_fdn=float(rad.wrk_sol.fdn_n[-1]), olr=float(rad.wrk_ir.fup_n[-1]),
               f_total=rad.f_total.copy())
    print(f"TOA solar fdn  = {out['toa_solar_fdn']:.6e} mW/m^2")
    print(f"TOA OLR        = {out['olr']:.6e} mW/m^2")
    print(f"net f_total[0] = {f0:.6e} mW/m^2")

    # the TOA spectra (the reference writes ModernEarth.dat; here an .npz)
    out["spectra_file"] = os.path.join(root, "ModernEarth.npz")
    np.savez(out["spectra_file"], sol_wavl=rad.sol.wavl, ir_wavl=rad.ir.wavl,
             fup_sol_toa=rad.wrk_sol.fup_a[-1], fdn_sol_toa=rad.wrk_sol.fdn_a[-1],
             fup_ir_toa=rad.wrk_ir.fup_a[-1])
    print("wrote", out["spectra_file"])

    print("--- opacities2yaml ---")
    out["opacities_yaml"] = rad.opacities2yaml()
    print(out["opacities_yaml"])

    # custom optical property round trip (test_radtran.f90:86-104)
    nw_c, nP_c = 4, 6
    wv = np.linspace(float(rad.sol.wavl[0]), float(rad.ir.wavl[-1]), nw_c)
    Pc = np.logspace(6.0, 0.0, nP_c)  # dynes/cm^2, decreasing
    rad.set_custom_optical_properties(wv, Pc, np.full((nP_c, nw_c), 1e-8),
                                      np.full((nP_c, nw_c), 0.5), np.full((nP_c, nw_c), 0.3))
    rad.radiate(T_surf, T, P, densities, dz, pdensities=pdensities, radii=radii)
    out["f_total_custom"] = float(rad.f_total[0])
    print(f"with custom opacity: net f_total[0] = {out['f_total_custom']:.6e}")
    rad.unset_custom_optical_properties()
    rad.radiate(T_surf, T, P, densities, dz, pdensities=pdensities, radii=radii)
    out["f_total_restored"] = float(rad.f_total[0])
    assert np.allclose(out["f_total_restored"], f0, rtol=1e-6), \
        "unset_custom_optical_properties did not restore baseline"
    print("custom optical property round-trip OK")
    return out


if __name__ == "__main__":
    main()
