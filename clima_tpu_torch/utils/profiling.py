"""Tracing / profiling helpers (SURVEY.md section 5: the reference has none).

Wraps torch.profiler so model runs can emit Chrome traces viewable in
Perfetto or chrome://tracing, plus a simple wall-clock timer for kernel
microbenchmarks; the JAX package's counterpart is
``clima_tpu/utils/profiling.py``.

Beside them, the port's own recorder (not in ``__all__``, which is the JAX
package's): :func:`span` marks a stage of the program, :func:`request` a
call of a column function. Spans are recorded only while recording is on:
inside :func:`recording`, inside :func:`trace`, and whenever a
``torch.profiler`` is active. Off, a span is one check and a shared no-op
context. On, it records its name, its id, its parent's and its root's ids,
its host start and end on the clock of the profiler's events (epoch ns,
``time.time_ns``), and, where CUDA is initialised, a start and an end CUDA
event on the current stream, from a pool. The events are resolved lazily,
after a device sync, into device times on the same host clock through an
anchor event taken when recording starts. Requests are recorded always, at
call granularity: host start and end and the growth of the program's
counters (``ops.cuda_graph``'s captures, capture and warm-up seconds and
replays, the ``launches`` of the seven kernel wrappers, and the
moist-adiabat march's ``event_splits`` and ``onset_columns``, which the
march counts only while recording is on). Records stay in
memory, in a ring of :data:`SPAN_RING` spans (the oldest dropped and
counted) and one of :data:`REQUEST_RING` requests, until :func:`records`
returns them or :func:`clear` empties both. No span emits a
``record_function`` range.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time

import torch

from .checkpoint import tree_flatten

__all__ = ["trace", "Timer", "time_fn"]


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager profiling the host and, where there is one, the CUDA
    device; on exit it writes a Chrome trace ``trace_<pid>_<ns>.json`` into
    ``logdir``, with the program's spans recorded meanwhile in two rows of
    their own (host stamps, and device markers where there are any) on the
    file's time base."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    with recording():
        first = _next_id
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            _write_spans(path, [s for s in records()["spans"] if s["id"] >= first])


class Timer:
    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0


def _sync(out):
    """Wait for the CUDA devices that hold a tensor of ``out`` (a tensor or
    a nested dict / list / tuple); CPU results are ready when returned."""
    leaves, _ = tree_flatten(out)
    for device in {x.device for x in leaves if torch.is_tensor(x) and x.is_cuda}:
        torch.cuda.synchronize(device)


def time_fn(fn, *args, n_iter=10, warmup=1):
    """Steady-state seconds/call of ``fn(*args)``, each call closed by a
    synchronisation of its outputs' CUDA devices."""
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args)
        _sync(out)
    return (time.perf_counter() - t0) / n_iter


# ---------------------------------------------------------------- recorder

SPAN_RING = 1 << 16  # spans kept; the oldest are dropped beyond it
REQUEST_RING = 64  # requests kept
EVENT_CHUNK = 256  # CUDA events the marker pool allocates at a time

_profiler_enabled = torch._C._autograd._profiler_enabled
_explicit = 0  # open recording() blocks
_anchor = None  # the markers' anchor; None after a span found recording off
_next_id = 1
_dropped = 0
_spans = collections.deque()
_requests = collections.deque(maxlen=REQUEST_RING)
_pool = []  # CUDA events free for markers
_streams = {}  # torch._C._cuda_getCurrentStream's key -> its torch.cuda.Stream
_local = threading.local()  # .stack: this thread's open records, innermost last


class _Anchor:
    """A CUDA event recorded on an idle device and its host time: a marker's
    host time is the anchor's plus the device time between them. An idle
    card runs the event as the host submits it, so its host time is the
    middle of the record call."""

    def __init__(self):
        self.event = torch.cuda.Event(enable_timing=True)
        self.event.record()  # creates the CUDA event, so the timed record is the record alone
        torch.cuda.synchronize()
        h0 = time.time_ns()
        self.event.record()
        self.ns = (h0 + time.time_ns()) // 2
        self.event.synchronize()
        if not _pool:
            _pool.extend(torch.cuda.Event(enable_timing=True) for _ in range(EVENT_CHUNK))


class _Record:
    __slots__ = ("id", "parent", "root", "name", "h0", "h1", "e0", "e1", "anchor", "d0", "d1",
                 "thread")

    def __init__(self, name, parent):
        global _next_id
        self.id, _next_id = _next_id, _next_id + 1
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.name, self.thread = name, threading.get_ident()
        self.e0 = self.e1 = self.anchor = self.d0 = self.d1 = self.h1 = None

    def as_dict(self):
        return dict(id=self.id, parent=self.parent, root=self.root, name=self.name,
                    host_start_ns=self.h0, host_end_ns=self.h1, device_start_ns=self.d0,
                    device_end_ns=self.d1, thread=self.thread)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _markable():
    """Whether a marker can be recorded now: CUDA is initialised and the
    current stream is not being captured into a graph."""
    return torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing()


def _marker():
    """A CUDA event from the pool, recorded now on the current stream (whose
    Stream object is kept: ``torch.cuda.current_stream()`` builds a new one
    each call, which costs more than the record)."""
    if not _pool:
        _pool.extend(torch.cuda.Event(enable_timing=True) for _ in range(EVENT_CHUNK))
    key = torch._C._cuda_getCurrentStream(torch.cuda.current_device())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                   device_type=key[2])
    event = _pool.pop()
    event.record(stream)
    return event


def _open(name, marked):
    global _anchor
    stack = _stack()
    rec = _Record(name, stack[-1] if stack else None)
    stack.append(rec)
    if marked and _markable():
        if _anchor is None:  # taken before the span starts, so it costs the span nothing
            _anchor = _Anchor()
        rec.anchor = _anchor
        rec.h0 = time.time_ns()
        rec.e0 = _marker()
    else:
        rec.h0 = time.time_ns()
    return rec


def _close(rec, kept):
    global _dropped
    if rec.e0 is not None and _markable():
        rec.e1 = _marker()
    rec.h1 = time.time_ns()
    stack = _stack()
    if stack and stack[-1] is rec:
        stack.pop()
    if kept:
        if len(_spans) >= SPAN_RING:
            old = _spans.popleft()
            _dropped += 1
            _pool.extend(e for e in (old.e0, old.e1) if e is not None)
            old.e0 = old.e1 = None
        _spans.append(rec)


class _Span:
    """An open span (recording on)."""

    __slots__ = ("name", "rec")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rec = _open(self.name, True)

    def __exit__(self, *exc):
        _close(self.rec, True)
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


class _Quiet:
    """A span while recording is off: nothing happens; one per name."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        pass

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


_QUIET = {}


def _decorate(name, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return spanned


def span(name):
    """A span of the program named ``name`` (``layer.stage``), as a context
    manager (``with span("radtran.opacity.mix"):``) or a decorator, which
    keeps the function's name and signature. Recorded only while recording
    is on; off, it is one check and a no-op context shared by every span of
    that name."""
    global _anchor
    if is_recording():
        return _Span(name)
    _anchor = None
    quiet = _QUIET.get(name)
    if quiet is None:
        quiet = _QUIET[name] = _Quiet(name)
    return quiet


def is_recording():
    """Whether the program's spans are recorded now: inside
    :func:`recording` or :func:`trace`, or while a ``torch.profiler`` is
    active."""
    return bool(_explicit or _profiler_enabled())


def _counters():
    """The program's counters now: {counter: {function name: value}}."""
    from ..adiabat import profile
    from ..ops import cuda_graph, march_cuda, rorr_cuda, twostream_cuda

    wrappers = (rorr_cuda.k_rorr_mix_cuda, twostream_cuda.two_stream_ir_weighted_cuda,
                twostream_cuda.two_stream_solar_multi_weighted_cuda,
                twostream_cuda.two_stream_ir_auto, twostream_cuda.two_stream_solar_multi_auto,
                twostream_cuda.two_stream_solar_auto, march_cuda.moist_adiabat_march_cuda)
    marches = (march_cuda.moist_adiabat_march_cuda, profile._march_torch)
    return dict(captures=dict(cuda_graph.CAPTURES), capture_s=dict(cuda_graph.CAPTURE_SECONDS),
                warmup_s=dict(cuda_graph.WARMUP_SECONDS), replays=dict(cuda_graph.REPLAYS),
                launches={w.__name__: w.launches for w in wrappers},
                event_splits={m.__name__: m.event_splits for m in marches},
                onset_columns={m.__name__: m.onset_columns for m in marches})


@contextlib.contextmanager
def request(name):
    """A call of a column function (``with request("adiabat.column_model"):``),
    recorded always in the ring of requests: host start and end and the
    growth of every counter of :func:`_counters` during the call. While
    recording is on it is also a root span, with markers, that the spans
    opened inside it name as their parent and root."""
    before = _counters()
    kept = is_recording()
    rec = _open(name, kept)
    try:
        yield
    finally:
        _close(rec, kept)
        after = _counters()
        growth = {k: {n: v - before[k].get(n, 0) for n, v in after[k].items()
                      if v != before[k].get(n, 0)} for k in after}
        _requests.append((rec, growth))


@contextlib.contextmanager
def recording():
    """Record the program's spans inside the block (they are also recorded
    whenever a ``torch.profiler`` is active)."""
    global _explicit, _anchor
    _explicit += 1
    _anchor = None
    try:
        yield
    finally:
        _explicit -= 1


def _resolve():
    """Device times of every marker recorded so far, after a device sync;
    their events go back to the pool."""
    pending = [r for r in _spans if r.e0 is not None]  # a request with markers is a span
    if not pending:
        return
    torch.cuda.synchronize()
    for r in pending:
        a = r.anchor
        r.d0 = a.ns + round(a.event.elapsed_time(r.e0) * 1e6)
        if r.e1 is not None:
            r.d1 = a.ns + round(a.event.elapsed_time(r.e1) * 1e6)
            _pool.append(r.e1)
        _pool.append(r.e0)
        r.e0 = r.e1 = None


def records():
    """The raw records: dict(spans=[...] in the order they opened,
    requests=[...] oldest first, dropped=spans dropped from the ring).

    A span is dict(id, parent, root, name, host_start_ns, host_end_ns,
    device_start_ns, device_end_ns, thread): ns on ``time.time_ns``'s clock,
    the device fields None without markers; ``parent`` is None for a root,
    whose ``root`` is its own id. A parent or root may be a request that
    opened while recording was off: it is among the requests alone. A
    request is the same with ``counters``,
    {counter: {function name: growth during the call}}, for the counters
    ``captures``, ``capture_s``, ``warmup_s``, ``replays``, ``launches``,
    ``event_splits`` and ``onset_columns``.
    """
    _resolve()
    spans = sorted(_spans, key=lambda r: r.id)
    return dict(spans=[r.as_dict() for r in spans],
                requests=[dict(r.as_dict(), counters=c) for r, c in _requests],
                dropped=_dropped)


def clear():
    """Empty both rings and the count of dropped spans."""
    global _dropped
    for r in [*_spans, *(r for r, _ in _requests)]:
        _pool.extend(e for e in (r.e0, r.e1) if e is not None)
        r.e0 = r.e1 = None
    _spans.clear()
    _requests.clear()
    _dropped = 0


# thread ids of the two rows the program's spans take in a Chrome trace
HOST_ROW, DEVICE_ROW = 1, 2


def _write_spans(path, spans):
    """Add ``spans`` (records()["spans"]) to the Chrome trace at ``path``, on
    its time base: a host row of the spans' host stamps and a device row of
    their markers, in this process."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = [dict(ph="M", name="thread_name", pid=pid, tid=tid, args=dict(name=label))
              for tid, label in ((HOST_ROW, "clima_tpu_torch spans (host)"),
                                 (DEVICE_ROW, "clima_tpu_torch spans (device markers)"))]
    for s in spans:
        rows = [(HOST_ROW, s["host_start_ns"], s["host_end_ns"]),
                (DEVICE_ROW, s["device_start_ns"], s["device_end_ns"])]
        for tid, t0, t1 in rows:
            if t0 is not None and t1 is not None:
                events.append(dict(ph="X", cat="clima_tpu_torch", name=s["name"], pid=pid,
                                   tid=tid, ts=(t0 - base) / 1e3, dur=(t1 - t0) / 1e3,
                                   args=dict(id=s["id"], parent=s["parent"], root=s["root"])))
    doc["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)
