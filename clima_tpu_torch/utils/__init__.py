from .errors import ClimaException
from .device import resolve_device

__all__ = ["ClimaException", "resolve_device"]
