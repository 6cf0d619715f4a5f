from .pipeline import (
    make_column_fns,
    batched_toa_fluxes,
    batched_surface_temperature,
    make_mesh,
    shard_columns,
    initialize_distributed,
)
from .solvers import (
    newton_solve,
    batched_make_column,
    batched_make_profile_bg_gas,
    batched_surface_temperature_trop,
    batched_surface_temperature_column,
    batched_surface_temperature_bg_gas,
)

__all__ = [
    "make_column_fns",
    "batched_toa_fluxes",
    "batched_surface_temperature",
    "make_mesh",
    "shard_columns",
    "initialize_distributed",
    "newton_solve",
    "batched_make_column",
    "batched_make_profile_bg_gas",
    "batched_surface_temperature_trop",
    "batched_surface_temperature_column",
    "batched_surface_temperature_bg_gas",
]
