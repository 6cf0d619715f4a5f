from .pipeline import make_column_fns, batched_toa_fluxes, batched_surface_temperature

__all__ = ["make_column_fns", "batched_toa_fluxes", "batched_surface_temperature"]
