from .climate import Climate, load_evolve_file

__all__ = ["Climate", "load_evolve_file"]
