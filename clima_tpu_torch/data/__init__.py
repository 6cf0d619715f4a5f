from .synthetic import (
    climate_settings_yaml_text,
    create_synthetic_datadir,
    make_template,
    make_template_dir,
    synthetic_datadir,
    write_species_yaml,
    write_settings_yaml,
    write_star_file,
    write_atmosphere_file,
)

__all__ = [
    "climate_settings_yaml_text",
    "create_synthetic_datadir",
    "make_template",
    "make_template_dir",
    "synthetic_datadir",
    "write_species_yaml",
    "write_settings_yaml",
    "write_star_file",
    "write_atmosphere_file",
]
