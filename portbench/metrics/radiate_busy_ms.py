"""radiate_busy_ms: device-busy ms per call of ``radiate_ir``,
``radiate_solar`` and both ``integrate_fluxes``, from their spans."""

SPANS = ("radiate_ir", "radiate_solar", "integrate")


def read(trace):
    spans = trace.get("span_busy_s", {})
    if not all(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s] for s in SPANS) / trace["calls"]
