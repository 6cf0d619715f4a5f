"""The mask updates of the PyTorch port's batched RCE
(clima_tpu_torch.adiabat.rce_device) against clima_tpu's (float64, CPU).

On test_torch_rce_device.py's template and models (nz=8, 1 zenith angle,
surface albedo 0.3, substeps 2; AdiabatClimate.from_reference): the three
mask-update modes of ``build_rce_fns`` on fixed states, each changing the
mask, against the JAX package's ``update_mask`` (jitted once for the
module): the same masks and locks.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
from clima_tpu.adiabat import rce_device as ref_rce_device
from clima_tpu.data import make_template_dir

from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.adiabat import rce_device
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, SUBSTEPS = 8, 2
TWO_ZONES = (np.arange(NZ) < 2) | ((np.arange(NZ) >= 5) & (np.arange(NZ) < 7))


def _files(t):
    return t["species"], t["settings"], t["star"], t["datadir"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    t = make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=NZ, n_zenith=1,
                          surface_albedo=0.3)
    ref = RefAdiabatClimate(*_files(t), substeps=SUBSTEPS)
    ref.verbose = False
    return ref, AdiabatClimate.from_reference(ref, *_files(t), device="cpu")


def earth_like_P_i(c):
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("CO2")] = 400.0
    P_i[c.species_names.index("N2")] = 1.0e6
    return P_i


def _batch(c, *arrays):
    """Host arrays of one column -> (1, ...) tensors on the port's model."""
    return tuple(torch.as_tensor(np.asarray(a)[None], device=c.device) for a in arrays)


# mode -> (state x, mask before the update, lock): states where each mode
# changes the mask (mode 1 retracts the zone, mode 2 promotes two layers,
# mode 3 retracts a zone top and counts the locks down)
X_SUPER = np.array([300.0, 295.0, 290.0, 240.0, 230.0, 220.0, 210.0, 200.0, 190.0])
UPDATE_STATES = {
    1: (X_SUPER, np.arange(NZ) < 2, np.zeros(NZ, np.int64)),
    2: (np.array([300.0, 240.0] + [150.0] * (NZ - 1)), np.zeros(NZ, bool),
        np.zeros(NZ, np.int64)),
    3: (X_SUPER, TWO_ZONES, np.array([0, 2, 0, 0, 1, 0, 0, 0])),
}


@pytest.fixture(scope="module")
def ref_update_mask(models):
    return jax.jit(ref_rce_device.build_rce_fns(models[0])["update_mask"])


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_update_mask_matches_reference(models, ref_update_mask, mode):
    """Each mode's update at a fixed state: the same mask and lock."""
    ref, c = models
    P_i = earth_like_P_i(c)
    x, save, lock = UPDATE_STATES[mode]
    want = ref_update_mask(jnp.asarray(mode), jnp.asarray(x), jnp.asarray(save),
                           jnp.asarray(lock, jnp.int32), jnp.asarray(P_i))
    fns = rce_device.build_rce_fns(c)
    got = fns["update_mask"](torch.tensor([mode]), *_batch(c, x, save, lock, P_i))
    assert (np.asarray(want[0]) != save).any()  # the state exercises the mode
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
