from .newton import ConvergedEarly, SolverError, hybrd, hybrj

__all__ = ["ConvergedEarly", "SolverError", "hybrd", "hybrj"]
