"""Time-stepping `Climate` model on a ModernEarth-like column (the port of
the JAX package's ``examples/climate_evolve.py``).

Mirrors the reference's ``tests/test_climate.f90`` workflow: build the
experimental `Climate` model (fixed-z grid, fixed composition from an
atmosphere.txt file), integrate dT/dt with radiative flux divergence and
mixing-length convective diffusion, streaming snapshots at log-spaced output
times (clima_climate.f90:23-69, clima_climate_integrate.f90:113-182). The
settings and the opacity database are built in memory; the atmosphere file
and the snapshot stream (an .npz, read back by `load_evolve_file`) are
written to ``root``.

    python -m clima_tpu_torch.examples.climate_evolve

runs on the CUDA card; ``main(device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import yaml

from ..climate import Climate, load_evolve_file
from ..config import settings_from_dict
from ..data import climate_settings_yaml_text, make_template, write_atmosphere_file
from ..utils.device import resolve_device

# 10 log-spaced output times (test_climate.f90 uses 100 to 1e10 s; the
# example stays short)
T_EVAL = np.logspace(4.0, 6.0, 10)


def make_model(root, nz=20, device=None):
    """``Climate`` with 1 zenith angle at ``nz`` layers from 0 to 70 km, its
    composition from the Earth-like atmosphere.txt written to ``root``."""
    t = make_template(nz=nz, n_zenith=1)
    settings = settings_from_dict(yaml.safe_load(climate_settings_yaml_text(nz=nz, n_zenith=1)),
                                  "<settings_climate>")
    atmosphere = os.path.join(root, "atmosphere.txt")
    write_atmosphere_file(atmosphere)
    return Climate(t["species"], settings, t["star"], atmosphere, t["datadir"], device=device)


def main(device=None, nz=20, root=None):
    """Run the evolve; returns its success, the stream's file and its fields."""
    resolve_device(device)
    root = root or tempfile.mkdtemp(prefix="clima_tpu_torch_climate_evolve_")
    c = make_model(root, nz, device)
    c.verbose = True

    path = os.path.join(root, "evolve_out.npz")
    ok = c.evolve(path, tstart=0.0, T_start=np.asarray(c.T_init), t_eval=T_EVAL,
                  overwrite=True)
    print("evolve converged:", ok)

    snaps = load_evolve_file(path)
    print(f"snapshots: {len(snaps['t'])} times, T shape {snaps['T'].shape}")
    print("T_surf(t):", np.array2string(snaps["T"][:, 0], precision=2))
    dT = float(np.abs(snaps["T"][-1] - snaps["T"][0]).max())
    print(f"max |T(t_end) - T(0)| = {dT:.3f} K")
    return dict(converged=bool(ok), evolve_file=path, snapshots=snaps, max_dT=dT,
                stats=dict(c.evolve_stats or {}))


if __name__ == "__main__":
    main()
