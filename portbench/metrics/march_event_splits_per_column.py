"""march_event_splits_per_column: the moist-adiabat march's event-split
substeps (a substep below the tropopause split at a latent-heat kink or a
condensation onset) per column of the traced call: the growth of the
program's counter ``event_splits`` over its last ``adiabat.column_model``
request, over the call's columns (``trace["columns"]``, which the recorded
adiabat entry gives). None where the program has no such counter."""

from portbench.metrics import _spans


def read(trace):
    splits = _spans.request_growth(trace, "event_splits")
    if splits is None or not trace.get("columns"):
        return None
    return splits / trace["columns"]
