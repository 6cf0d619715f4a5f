"""solar_weighted_roofline_pct: the weighted multi-zenith solar two-stream
kernel's (``solar_weighted_kernel``, #2) share of its roofline, without amean,
``_roofline.solar_weighted_work``."""

from portbench.metrics import _kernels, _roofline


def read(trace):
    return _kernels.roofline_pct(trace, "solar_weighted_kernel",
                                 lambda s: _roofline.solar_weighted_work(
                                     s["solar_rows"], s["nz"], s["n_zenith"], s["nbin"]))
