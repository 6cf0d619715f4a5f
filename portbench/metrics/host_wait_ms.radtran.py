"""host_wait_ms.radtran: ms per radtran call in which the stream had run dry
before the host entered the program's next leaf span (``_spans.host_wait_ms``
over the traced calls of the final profiler pass)."""

from portbench.metrics import _spans


def read(trace):
    return _spans.host_wait_ms(_spans.traced_calls(trace))
