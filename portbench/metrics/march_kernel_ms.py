"""march_kernel_ms: device ms of the moist-adiabat march kernel in the traced
call, between the markers of the program's span
``adiabat.profile.march.kernel`` (the launch alone) inside the program's
last ``adiabat.column_model`` request. None where the program records no
such span or its markers (a program without the span, or the CPU)."""

from portbench.metrics import _spans

SPAN = "adiabat.profile.march.kernel"


def read(trace):
    req = _spans.last_request(trace)
    if req is None:
        return None
    spans = [s for s in _spans.program_records()["spans"]
             if s["root"] == req["id"] and s["name"] == SPAN]
    if not spans or not all(s["device_start_ns"] is not None and s["device_end_ns"] is not None
                            for s in spans):
        return None
    return sum(s["device_end_ns"] - s["device_start_ns"] for s in spans) / 1e6
