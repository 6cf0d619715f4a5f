from .radtran import Radtran, ClimaRadtranWrk, RTChannelView
from .data import (
    OpticalData,
    load_optical_data,
    load_channel,
    read_stellar_flux,
    optical_data_from_numpy,
)
from .opacity import compute_opacity
from .radiate import radiate_ir, radiate_solar, integrate_fluxes

__all__ = [
    "Radtran",
    "ClimaRadtranWrk",
    "RTChannelView",
    "OpticalData",
    "load_optical_data",
    "load_channel",
    "read_stellar_flux",
    "optical_data_from_numpy",
    "compute_opacity",
    "radiate_ir",
    "radiate_solar",
    "integrate_fluxes",
]
