"""capture_ms_per_call: the growth of ``ops.cuda_graph.CAPTURE_SECONDS`` (every
function: the march's interval and the altitude's) per call, in ms."""


def read(trace):
    s = trace.get("counters", {}).get("capture_s")
    return None if s is None else 1e3 * s / trace["calls"]
