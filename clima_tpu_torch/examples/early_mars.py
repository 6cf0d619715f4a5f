"""Early-Mars style climate sweep (the port of the JAX package's
``examples/early_mars.py``, which mirrors the reference's
``examples/EarlyMars.ipynb``).

Surface temperature against the CO2 inventory of a cold early Mars under a
faint young Sun: the six columns are solved together by
``batched_surface_temperature`` on the ``columns`` mesh (``make_mesh()``;
one rank without a process group, every rank of it under ``torchrun``)
instead of the reference's serial Python loop.

    python -m clima_tpu_torch.examples.early_mars

runs on the CUDA card; ``main(device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import yaml

from ..adiabat import AdiabatClimate
from ..config import settings_from_dict
from ..data import make_template
from ..data.synthetic import settings_yaml_text
from ..parallel import batched_surface_temperature, make_mesh
from ..utils.device import resolve_device

P_CO2_BARS = np.array([0.1, 0.3, 0.5, 1.0, 2.0, 3.0])


def mars_settings(nz=20):
    """Mars mass and radius and the faint-young-Sun photon scale factor
    (templates/AdiabatClimate/Mars/settings.yaml)."""
    text = settings_yaml_text(nz=nz, planet_mass=6.4169e26, planet_radius=3.3895e8,
                              surface_albedo=0.2, n_zenith=1,
                              photon_scale_factor=0.4286 * 0.75)
    return settings_from_dict(yaml.safe_load(text), "<settings_mars>")


def mars_model(nz=20, device=None, substeps=None):
    """The Mars model on the in-memory template (``substeps`` None: the
    model's default)."""
    t = make_template(nz=nz, n_zenith=1)
    c = AdiabatClimate(t["species"], mars_settings(nz), t["star"], t["datadir"], device=device,
                       **({} if substeps is None else {"substeps": substeps}))
    c.verbose = False
    return c


def mars_P_i(c):
    """(6, ng): 270 bar of water and P_CO2_BARS of CO2, nothing else."""
    P_i = np.full((len(P_CO2_BARS), c.sp.ng), 1.0e-15)
    P_i[:, c.species_names.index("H2O")] = 270.0e6
    P_i[:, c.species_names.index("CO2")] = P_CO2_BARS * 1.0e6
    return P_i


def main(device=None, nz=20, root=None, substeps=None):
    """Run the sweep; returns the CO2 inventories, T_surf, convergence and
    iterations. ``root`` is accepted for the examples' common signature; this
    example writes no file. ``substeps`` (None: the model's 6) coarsens the
    march for quick runs on the CPU.

    As in the JAX package, the batched damped Newton stops after 30 steps:
    at 20 layers it leaves the 1 and 2 bar columns unconverged, as the JAX
    package's own example does, and returns their last iterates."""
    resolve_device(device)
    c = mars_model(nz, device, substeps)
    P_i = mars_P_i(c)
    mesh = make_mesh()
    T, resid, conv, iters = batched_surface_temperature(c, P_i, T_guess=230.0, mesh=mesh)
    T, resid, conv = (x.detach().cpu().numpy() for x in (T, resid, conv))
    iters = int(iters)
    print(f"batched solve over {mesh.size()} rank(s), {iters} iterations")
    for p, Ts, ok in zip(P_CO2_BARS, T, conv):
        print(f"  P_CO2 = {p:4.1f} bar  ->  T_surf = {Ts:7.2f} K   converged={bool(ok)}")
    return dict(P_CO2_bars=P_CO2_BARS.copy(), T_surf=T, residual=resid,
                converged=conv.astype(bool), iterations=iters, ranks=mesh.size())


if __name__ == "__main__":
    main()
