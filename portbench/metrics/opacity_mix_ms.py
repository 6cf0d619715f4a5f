"""opacity_mix_ms: device marker ms per call of ``compute_opacity``'s
k-distribution mixing (the RORR kernel), the span ``radtran.opacity.mix``."""

from portbench.metrics import _spans


def read(trace):
    return _spans.stage_ms(trace, ("mix",))
