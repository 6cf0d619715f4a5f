from .adiabat import AdiabatClimate, FREE_PARAMETERS

__all__ = ["AdiabatClimate", "FREE_PARAMETERS"]
