"""Error type matching the reference Python API (`clima/cython/_clima.pyx`)."""


class ClimaException(Exception):
    """Raised on any model error (mirrors the reference's ClimaException)."""
