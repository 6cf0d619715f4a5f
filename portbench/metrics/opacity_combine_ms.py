"""opacity_combine_ms: device marker ms per call of ``compute_opacity``'s
final combine, the span ``radtran.opacity.combine``."""

from portbench.metrics import _spans


def read(trace):
    return _spans.stage_ms(trace, ("combine",))
