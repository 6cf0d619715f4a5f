"""The benchmark's CPU tests drive its runs at small sizes on one torch thread."""

import copy
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True, scope="session")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(workload):
    """Overrides that cut a cell to a size a CPU test can hold: few columns,
    few layers, few substeps."""
    if workload.startswith("earth_radtran"):
        return dict(config={"radiative_layers": 14},
                    traffic={"columns_per_call": 4, "distinct_batches": 2})
    if workload.startswith("modern_earth_radtran"):
        return dict(config={"radiative_layers": 8},
                    traffic={"columns_per_call": 4, "distinct_batches": 2})
    with open(os.path.join(ROOT, "portbench", "configs", "earth_adiabat.json")) as f:
        settings = copy.deepcopy(json.load(f)["settings"])
    settings["atmosphere-grid"]["number-of-layers"] = 5
    return dict(config={"settings": settings, "radiative_layers": 12, "substeps": 2},
                traffic={"columns_per_call": 4, "checked_columns": 64})


WORKLOADS = ("earth_radtran.c1024", "modern_earth_radtran.haze.c4096",
             "earth_adiabat.sweep.c1024")
