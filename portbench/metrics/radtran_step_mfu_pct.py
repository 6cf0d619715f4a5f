"""radtran_step_mfu_pct: the whole radtran call's share of the card's peak:
the least time for the call's counted bytes and FP64 operations
(``compute_opacity``, #1 and #2; the larger of bytes over 3.35 TB/s and
operations over 34 TFLOP/s) over the measured host time per traced call."""

from portbench.metrics import _roofline


def read(trace):
    if "call_s" not in trace or not trace.get("shapes"):
        return None
    s = trace["shapes"]
    parts = [_roofline.opacity_work(s["columns"], s["nz"], s["nw"], s["nbin"], s["ng"], s["nk"]),
             _roofline.ir_weighted_work(s["ir_rows"], s["nz"], s["nbin"]),
             _roofline.solar_weighted_work(s["solar_rows"], s["nz"], s["n_zenith"], s["nbin"])]
    least_ms = _roofline.bound(sum(b for b, _ in parts), sum(o for _, o in parts))[0]
    return 100.0 * least_ms / 1e3 / trace["call_s"]
