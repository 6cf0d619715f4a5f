"""opacity_busy_ms: device-busy ms per call of ``compute_opacity``, the union
of the kernel and copy intervals launched inside its span."""


def read(trace):
    busy = trace.get("span_busy_s", {}).get("opacity")
    return None if busy is None else 1e3 * busy / trace["calls"]
