"""The mesh helpers of the port without a model (CPU): make_mesh() without a
process group starting none, so that initialize_distributed can follow it,
and each of the eight batched entry points raising ``ValueError`` on a batch
that does not divide over a two-rank mesh (a process group of the ``fake``
backend, which runs no collective) before it touches the model, as placing
the batch on an indivisible ``NamedSharding`` does in JAX. The sharded
calls themselves are in ``test_torch_distributed.py``."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from clima_tpu_torch.adiabat import rce_device
from clima_tpu_torch.parallel import (
    batched_make_column,
    batched_make_profile_bg_gas,
    batched_surface_temperature,
    batched_surface_temperature_bg_gas,
    batched_surface_temperature_column,
    batched_surface_temperature_trop,
    batched_toa_fluxes,
    initialize_distributed,
    make_mesh,
    shard_columns,
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def no_process_group():
    """No process group before and after the test."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_starts_no_process_group(no_process_group):
    """make_mesh() without a process group is a one-rank mesh that starts
    none, so initialize_distributed can join one afterwards (gloo here, one
    rank); its mesh is one rank too, which distribute_tensor takes with
    shard_columns' placement."""
    assert make_mesh().size() == 1 and not dist.is_initialized()
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    mesh = make_mesh()
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("columns",)
    from torch.distributed.tensor import distribute_tensor

    x = torch.arange(8.0)
    assert torch.equal(distribute_tensor(x, *shard_columns(mesh)).to_local(), x)


ENTRY_POINTS = {
    "batched_toa_fluxes": lambda mesh: batched_toa_fluxes(None, np.ones(3), np.ones((3, 2)),
                                                          mesh=mesh),
    "batched_surface_temperature": lambda mesh: batched_surface_temperature(
        None, np.ones((3, 2)), mesh=mesh),
    "batched_make_column": lambda mesh: batched_make_column(None, np.ones(3), np.ones((3, 2)),
                                                            mesh=mesh),
    "batched_make_profile_bg_gas": lambda mesh: batched_make_profile_bg_gas(
        None, np.ones(3), np.ones((3, 2)), np.ones(3), "N2", mesh=mesh),
    "batched_surface_temperature_trop": lambda mesh: batched_surface_temperature_trop(
        None, np.ones((3, 2)), mesh=mesh),
    "batched_surface_temperature_column": lambda mesh: batched_surface_temperature_column(
        None, np.ones((3, 2)), mesh=mesh),
    "batched_surface_temperature_bg_gas": lambda mesh: batched_surface_temperature_bg_gas(
        None, np.ones((3, 2)), np.ones(3), "N2", mesh=mesh),
    "batched_rce": lambda mesh: rce_device.batched_rce(None, np.ones((3, 2)), 280.0,
                                                       np.ones((3, 4)), mesh=mesh),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_indivisible_batch_raises(name, no_process_group):
    """Three columns over two ranks raise before the model (None here) is
    touched, as placing them on an indivisible NamedSharding does in JAX."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    mesh = make_mesh()
    assert mesh.size() == 2
    with pytest.raises(ValueError, match="3 columns does not divide over a mesh of 2"):
        ENTRY_POINTS[name](mesh)
