from .errors import ClimaException

__all__ = ["ClimaException"]
