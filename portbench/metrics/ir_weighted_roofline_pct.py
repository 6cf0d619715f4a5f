"""ir_weighted_roofline_pct: the weighted IR two-stream kernel's
(``ir_weighted_kernel``, #1) share of its roofline, ``_roofline.ir_weighted_work``."""

from portbench.metrics import _kernels, _roofline


def read(trace):
    return _kernels.roofline_pct(trace, "ir_weighted_kernel", lambda s: _roofline.ir_weighted_work(
        s["ir_rows"], s["nz"], s["nbin"]))
