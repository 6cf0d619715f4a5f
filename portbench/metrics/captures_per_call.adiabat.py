"""captures_per_call.adiabat: CUDA graphs captured during the traced call,
the growth of ``ops.cuda_graph.CAPTURES`` over the program's last
``adiabat.column_model`` request."""

from portbench.metrics import _spans


def read(trace):
    return _spans.request_growth(trace, "captures")
