"""device_idle_pct.radtran: the share of the traced window in which the device
ran nothing (``_trace.idle_pct``)."""

from portbench.metrics._trace import idle_pct as read  # noqa: F401
