"""Reading a ``torch.profiler`` trace of traced calls.

A copy of the arithmetic of the port's stage tool, with the span attribution
the benchmark adds: device-busy time is the union of the card's kernel, copy
and set intervals; kernels are summed by name; the host's launch calls are
counted, and a pass that recorded fewer kernels than launch calls lost
records (seen on an H100 in a process that had started child processes) and
is repeated, up to ``PASSES`` passes. Each device interval belongs to the
benchmark span (a ``record_function`` range) in which the host op that
launched it started, found through the profiler's correlation of device
events with host events; the idle gap before an interval is charged to that
span too, since the host was still inside it when the card ran dry. The
profiler's device-side copies of the spans themselves are left out.
"""

from __future__ import annotations

import bisect
import re

__all__ = ["LAUNCH_CALLS", "PASSES", "read_profile", "busy_union", "idle_pct", "short_name",
           "kernel_name"]

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
PASSES = 3


def short_name(full):
    """A device operation's name without its argument list, return type and
    anonymous namespace, at most 80 characters."""
    n = full.replace("(anonymous namespace)::", "")
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    return (n[5:] if n.startswith("void ") else n)[:80]


def kernel_name(full):
    """A kernel's bare identifier: ``rorr_chain_kernel`` of
    ``void (anonymous namespace)::rorr_chain_kernel<double, 8>(double const*)``."""
    head = re.split(r"[<(]", full.replace("(anonymous namespace)::", ""), maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else full


def busy_union(intervals):
    """Seconds covered by the union of (start, end) intervals in ns."""
    busy, end = 0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e9


def idle_pct(trace):
    """The share of a traced window in which the device ran nothing, 1 -
    busy / window, in %; None where the busy time was not measured."""
    return None if "busy_s" not in trace else 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def read_profile(prof, span_names):
    """What one profiler pass saw: dict(ok, busy_s, matched (how device
    events were tied to host events), span_busy_s {span:
    s}, kernels {name: [s, count]}, kernel_records, launch_calls,
    unattributed (device intervals outside every span), gaps {span: idle
    s}). ``ok`` is False where records were lost."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host, runtime, spans, device, launches = {}, {}, [], [], 0
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if e.name() in span_names:  # the device-side copy of a benchmark span
                continue
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                           e.linked_correlation_id(), e.correlation_id()))
            continue
        name = e.name()
        launches += name.startswith(LAUNCH_CALLS)
        host[e.correlation_id()] = e.start_ns()
        if name.startswith(("cuda", "cu")):
            runtime[e.correlation_id()] = e.start_ns()
        if name in span_names:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    spans.sort()
    starts = [s for s, _, _ in spans]

    def span_of(t):
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and t <= spans[i][1] else None

    kernels, by_span, records, lost = {}, {}, 0, {}
    device.sort()
    gaps, end = {}, None
    how = {"linked": 0, "runtime": 0, "none": 0}
    for s, e, name, linked, own in device:
        # the host op (or benchmark span) that was open when the work was
        # launched, else the runtime call that launched it
        by_link = linked > 0 and linked in host
        t = host[linked] if by_link else runtime.get(own)
        how["linked" if by_link else "runtime" if own in runtime else "none"] += 1
        span = span_of(t)
        by_span.setdefault(span, []).append((s, e))
        if span is None:
            lost[name] = lost.get(name, 0.0) + (e - s) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            records += 1
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += (e - s) / 1e9
            k[1] += 1
        if end is not None and s > end:
            gaps[span] = gaps.get(span, 0.0) + (s - end) / 1e9
        end = e if end is None else max(end, e)
    return dict(ok=records >= launches and records > 0,
                busy_s=busy_union([(s, e) for s, e, _, _, _ in device]), matched=how,
                span_busy_s={k: busy_union(v) for k, v in by_span.items() if k is not None},
                unattributed=len(by_span.get(None, [])),
                unattributed_s={short_name(k): v for k, v in
                                sorted(lost.items(), key=lambda kv: -kv[1])[:5]},
                kernels=kernels, kernel_records=records, launch_calls=launches,
                gaps={k: v for k, v in gaps.items() if k is not None})
