"""profile_ms: host ms per call, synced at both ends, of the moist-adiabat
march (``make_profile_core``, its captures included)."""


def read(trace):
    s = trace.get("span_host_s", {}).get("profile")
    return None if s is None else 1e3 * s / trace["calls"]
