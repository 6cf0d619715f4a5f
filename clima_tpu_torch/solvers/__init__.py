from .newton import ConvergedEarly, SolverError, hybrd, hybrj
from .ptc import PTCSolver, PTC_CONVERGED_USER, PTC_REASONS

__all__ = ["ConvergedEarly", "SolverError", "hybrd", "hybrj", "PTCSolver",
           "PTC_CONVERGED_USER", "PTC_REASONS"]
