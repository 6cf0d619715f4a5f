"""A kernel's share of its roofline from the traced calls: the least time of
its counted bytes and operations at the published peaks over its measured
device time per call. None where no record of the kernel was read."""

from portbench.metrics import _roofline, _trace


def roofline_pct(trace, kernel, work):
    """``kernel``: the kernel's name as the profiler reports it, without its
    return type and template arguments; ``work``: a function of the trace's
    shapes giving (bytes, operations) per call."""
    seconds = sum(s for name, (s, _) in trace.get("kernels", {}).items()
                  if _trace.kernel_name(name) == kernel)
    if not seconds:
        return None
    return 100.0 * _roofline.bound(*work(trace["shapes"]))[0] / 1e3 / (seconds / trace["calls"])
