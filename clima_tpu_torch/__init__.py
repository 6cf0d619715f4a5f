"""clima_tpu_torch: the PyTorch + CUDA port of clima_tpu.

Correlated-k two-stream radiative transfer and moist-adiabat climate
models (``AdiabatClimate``) for 1-D planetary climate columns, on PyTorch
tensors with hand-written CUDA kernels for NVIDIA Hopper (``csrc/``). It mirrors the module paths and names of the JAX package
``clima_tpu``, which stays the reference it is tested against, and never
imports JAX. Plain PyTorch twins of every kernel run on the CPU.
"""

from .utils.errors import ClimaException
from .radtran import Radtran, ClimaRadtranWrk
from .adiabat import (
    AdiabatClimate,
    RCE_SOLVE_HYBRJ_ONLY,
    RCE_SOLVE_PTC_THEN_HYBRJ,
    RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ,
)
from .ops.rebin import rebin, rebin_with_errors

__version__ = "0.2.0"

__all__ = [
    "ClimaException",
    "Radtran",
    "ClimaRadtranWrk",
    "AdiabatClimate",
    "RCE_SOLVE_HYBRJ_ONLY",
    "RCE_SOLVE_PTC_THEN_HYBRJ",
    "RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ",
    "rebin",
    "rebin_with_errors",
]
