from .adiabat import (
    AdiabatClimate,
    FREE_PARAMETERS,
    RCE_SOLVE_HYBRJ_ONLY,
    RCE_SOLVE_PTC_THEN_HYBRJ,
    RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ,
)
from . import rce as _rce  # attaches RCE / make_profile_rc methods

__all__ = [
    "AdiabatClimate",
    "FREE_PARAMETERS",
    "RCE_SOLVE_HYBRJ_ONLY",
    "RCE_SOLVE_PTC_THEN_HYBRJ",
    "RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ",
]
