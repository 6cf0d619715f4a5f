"""radtran_ms.adiabat: host ms per call, synced at both ends, of the
radiative-transfer chain inside ``column_model`` (``compute_opacity`` to the
second ``integrate_fluxes``)."""


def read(trace):
    s = trace.get("span_host_s", {}).get("radtran")
    return None if s is None else 1e3 * s / trace["calls"]
