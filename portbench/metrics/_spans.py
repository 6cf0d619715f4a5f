"""Reading the program's own records after the traced calls.

The program (``clima_tpu_torch.utils.profiling``) hands over raw records
only: each span's name, id, parent and root ids, host start and end and,
on a card, the device times of its start and end markers, all on one host
clock; and each request's growth of the program's counters. The arithmetic
that turns them into metrics is here, so the yardstick stays the
benchmark's. A program without the recorder, or a run that recorded
nothing, reads None.

In a radtran cell the traced calls run under ``torch.profiler``, which turns
the program's recording on: each call is the spans from one root
``radtran.opacity`` up to the next, and the traced calls of the final
profiler pass are the last ``trace["calls"]`` of them. The adiabat cell's
traced call is the last ``adiabat.column_model`` request.
"""

from __future__ import annotations

__all__ = ["program_records", "radtran_calls", "traced_calls", "leaves", "self_ns", "stage_ms",
           "host_wait_ms", "last_request", "request_growth"]

OPACITY_ROOT = "radtran.opacity"
COLUMN_REQUEST = "adiabat.column_model"


def program_records():
    """The program's records (``profiling.records()``), or None where the
    program has no recorder."""
    try:
        from clima_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    return None if read is None else read()


def radtran_calls(spans, calls):
    """The spans of the last ``calls`` radtran calls, a list per call: each
    from a root ``radtran.opacity`` (by host start) up to the next one, the
    last up to the end; None where fewer were recorded."""
    starts = [s["host_start_ns"] for s in spans
              if s["name"] == OPACITY_ROOT and s["parent"] is None][-calls:] if calls else []
    if not starts or len(starts) < calls:
        return None
    ends = starts[1:] + [float("inf")]
    return [[s for s in spans if a <= s["host_start_ns"] < b] for a, b in zip(starts, ends)]


def leaves(spans):
    """The spans among ``spans`` that no other of them names as its parent,
    in the order the host opened them."""
    parents = {s["parent"] for s in spans}
    return sorted((s for s in spans if s["id"] not in parents), key=lambda s: s["host_start_ns"])


def _covered(t0, t1, intervals):
    """ns of [t0, t1] covered by the union of ``intervals``."""
    covered, end = 0, t0
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, t1)
        if b > a:
            covered += b - a
            end = b
    return covered


def self_ns(spans):
    """{span id: (host self ns, device self ns or None)}: a span's duration
    less the part of its interval that its children cover, on the host
    stamps and on the markers."""
    children = {}
    for s in spans:
        children.setdefault(s["parent"], []).append(s)
    out = {}
    for s in spans:
        kids = children.get(s["id"], [])
        h0, h1 = s["host_start_ns"], s["host_end_ns"]
        host = h1 - h0 - _covered(h0, h1, [(k["host_start_ns"], k["host_end_ns"]) for k in kids])
        d0, d1 = s["device_start_ns"], s["device_end_ns"]
        device = None
        if d0 is not None and d1 is not None and all(k["device_end_ns"] is not None
                                                     for k in kids):
            device = d1 - d0 - _covered(d0, d1, [(k["device_start_ns"], k["device_end_ns"])
                                                 for k in kids])
        out[s["id"]] = (host, device)
    return out


def _marked(spans):
    return all(s["device_start_ns"] is not None and s["device_end_ns"] is not None
               for s in spans)


def traced_calls(trace):
    """The spans of the traced radtran calls of the final profiler pass, a
    list per call, or None."""
    records = program_records()
    if records is None:
        return None
    return radtran_calls(records["spans"], int(trace.get("calls") or 0))


def stage_ms(trace, stages):
    """Device marker ms per traced radtran call of the spans
    ``radtran.opacity.<stage>`` for ``stages``: their kernels and the idle
    while the host was inside them. None where a call lacks them or their
    markers."""
    calls = traced_calls(trace)
    if calls is None:
        return None
    names = {f"{OPACITY_ROOT}.{stage}" for stage in stages}
    total = 0
    for call in calls:
        picked = [s for s in call if s["name"] in names]
        if not picked or not _marked(picked):
            return None
        total += sum(s["device_end_ns"] - s["device_start_ns"] for s in picked)
    return total / 1e6 / len(calls)


def host_wait_ms(calls):
    """ms per call in which the stream had run dry before the host entered
    the next span: over consecutive leaves A -> B of a call (by host start),
    the sum of max(0, B's host start - A's end marker). A lower bound of the
    host-paced idle; the gap between calls is not counted. None where a leaf
    lacks its markers."""
    if not calls:
        return None
    total = 0
    for call in calls:
        ls = leaves(call)
        if len(ls) < 2 or not _marked(ls):
            return None
        total += sum(max(0, b["host_start_ns"] - a["device_end_ns"]) for a, b in zip(ls, ls[1:]))
    return total / 1e6 / len(calls)


def last_request(trace, name=COLUMN_REQUEST):
    """The program's last request ``name``, where ``trace`` is the adiabat
    entry's traced call (it carries the entry's ``counters``); else None."""
    if "counters" not in trace:
        return None
    records = program_records()
    found = [r for r in (records or {}).get("requests", []) if r["name"] == name]
    return found[-1] if found else None


def request_growth(trace, counter):
    """The growth of one of the program's counters (summed over its
    functions) during the last ``adiabat.column_model`` request, or None."""
    req = last_request(trace)
    if req is None or counter not in req["counters"]:
        return None
    return sum(req["counters"][counter].values())
