"""altitude_ms: host ms per call, synced at both ends, of the altitude solve
(``compute_altitude_core``, its capture included)."""


def read(trace):
    s = trace.get("span_host_s", {}).get("altitude")
    return None if s is None else 1e3 * s / trace["calls"]
