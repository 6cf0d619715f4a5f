"""opacity_continua_ms: device marker ms per call of ``compute_opacity``'s
continua, the spans ``radtran.opacity.rayleigh``, ``.absorption``,
``.custom`` and ``.particles``."""

from portbench.metrics import _spans


def read(trace):
    return _spans.stage_ms(trace, ("rayleigh", "absorption", "custom", "particles"))
