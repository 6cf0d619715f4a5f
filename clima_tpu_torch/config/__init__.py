from .species import Species, GasThermo, heat_capacity, load_species, species_from_dict
from .settings import ClimaSettings, SettingsOpacity, load_settings, settings_from_dict
from .atmosphere_file import AtmosphereFile, unpack_atmospherefile

__all__ = [
    "Species",
    "GasThermo",
    "heat_capacity",
    "load_species",
    "species_from_dict",
    "ClimaSettings",
    "SettingsOpacity",
    "load_settings",
    "settings_from_dict",
    "AtmosphereFile",
    "unpack_atmospherefile",
]
