"""capture_warmup_ms_per_call: host ms of the eager warm-up runs before the
traced call's captures, the growth of ``ops.cuda_graph.WARMUP_SECONDS`` over
the program's last ``adiabat.column_model`` request."""

from portbench.metrics import _spans


def read(trace):
    s = _spans.request_growth(trace, "warmup_s")
    return None if s is None else 1e3 * s
