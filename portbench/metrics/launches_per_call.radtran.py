"""launches_per_call.radtran: the host's kernel launch calls per radtran call."""


def read(trace):
    n = trace.get("launch_calls")
    return None if n is None else n / trace["calls"]
