"""opacity_ktables_ms: device marker ms per call of ``compute_opacity``'s
k-table stages, the spans ``radtran.opacity.kweights`` and ``.kdist``."""

from portbench.metrics import _spans


def read(trace):
    return _spans.stage_ms(trace, ("kweights", "kdist"))
