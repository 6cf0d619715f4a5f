"""graph_replays_per_call.adiabat: CUDA-graph replays (the march's and the
altitude's intervals) during the traced call, the growth of
``ops.cuda_graph.REPLAYS`` over the program's last ``adiabat.column_model``
request."""

from portbench.metrics import _spans


def read(trace):
    return _spans.request_growth(trace, "replays")
