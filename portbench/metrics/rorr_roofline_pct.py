"""rorr_roofline_pct: the RORR kernel's (``rorr_chain_kernel``, ``ops.rorr_cuda``)
share of its roofline, bytes and operations of ``_roofline.rorr_work``."""

from portbench.metrics import _kernels, _roofline


def read(trace):
    return _kernels.roofline_pct(trace, "rorr_chain_kernel", lambda s: _roofline.rorr_work(
        s["rorr_lanes"], s["nbin"], s["nk"]))
