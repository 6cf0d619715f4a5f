"""Tutorial: the AdiabatClimate model (the port of the JAX package's
``examples/tutorial_adiabat_climate.py``, which mirrors the reference's
``examples/Tutorial_AdiabatClimate.ipynb``).

TOA fluxes of a moist pseudoadiabat, the equilibrium surface temperature,
full radiative-convective equilibrium seeded from it, the column, and the
column written out with ``out2atmosphere_txt`` to ``root``. Runs against
the synthetic opacity database, built in memory (``data.make_template``).

    python -m clima_tpu_torch.examples.tutorial_adiabat_climate

runs on the CUDA card; ``main(device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..adiabat import AdiabatClimate
from ..data import make_template
from ..utils.device import resolve_device


def earth_P_i(c):
    """Earth-ish surface partial pressures (dynes/cm^2): a 270-bar ocean,
    400 ppm CO2, 0.78 bar N2."""
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0e-6 * 1.0e6
    P_i[c.species_names.index("N2")] = 0.78e6
    return P_i


def main(device=None, nz=20, root=None, substeps=None):
    """Run the tutorial; returns its printed numbers and the written file.
    ``substeps`` (None: the model's 6) coarsens the march for quick runs on
    the CPU."""
    resolve_device(device)
    root = root or tempfile.mkdtemp(prefix="clima_tpu_torch_tutorial_")
    t = make_template(nz=nz, n_zenith=1)
    c = AdiabatClimate(t["species"], t["settings"], t["star"], t["datadir"], device=device,
                       **({} if substeps is None else {"substeps": substeps}))
    c.verbose = False
    P_i = earth_P_i(c)

    # 1. a moist pseudoadiabat and its TOA fluxes
    ISR, OLR = c.TOA_fluxes(280.0, P_i)
    print(f"T_surf=280 K: ISR = {ISR/1e3:.1f} W/m^2, OLR = {OLR/1e3:.1f} W/m^2")

    # 2. the equilibrium surface temperature
    T_surf = c.surface_temperature(P_i, T_guess=280.0)
    print(f"surface_temperature: {T_surf:.2f} K")

    # 3. full radiative-convective equilibrium, seeded from step 2
    converged = c.RCE(P_i, T_surf, c.T)
    print(f"RCE converged: {converged}; T_surf = {c.T_surf:.2f} K")
    n_conv = int(np.sum(c.convecting_with_below))
    print(f"convective layers: {n_conv}/{c.nz}")

    # 4. the column
    for i in range(0, c.nz, 5):
        print(f"  P = {c.P[i]/1e6:9.3e} bar   T = {c.T[i]:7.2f} K   "
              f"fH2O = {c.f_i[i, c.species_names.index('H2O')]:.3e}")

    # 5. written out
    path = os.path.join(root, "earth_rce_atmosphere.txt")
    c.out2atmosphere_txt(path, np.zeros(c.nz), overwrite=True)
    print("wrote", path)
    return dict(ISR=ISR, OLR=OLR, T_surf_solve=T_surf, converged=bool(converged),
                T_surf=float(c.T_surf), convective_layers=n_conv, P=c.P.copy(), T=c.T.copy(),
                atmosphere_file=path)


if __name__ == "__main__":
    main()
