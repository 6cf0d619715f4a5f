from .synthetic import (
    create_synthetic_datadir,
    make_template,
    make_template_dir,
    synthetic_datadir,
    write_species_yaml,
    write_settings_yaml,
    write_star_file,
)

__all__ = [
    "create_synthetic_datadir",
    "make_template",
    "make_template_dir",
    "synthetic_datadir",
    "write_species_yaml",
    "write_settings_yaml",
    "write_star_file",
]
