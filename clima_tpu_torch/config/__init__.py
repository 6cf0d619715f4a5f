from .species import Species, GasThermo, load_species, species_from_dict
from .settings import ClimaSettings, SettingsOpacity, load_settings, settings_from_dict

__all__ = [
    "Species",
    "GasThermo",
    "load_species",
    "species_from_dict",
    "ClimaSettings",
    "SettingsOpacity",
    "load_settings",
    "settings_from_dict",
]
