"""The port's in-program recorder (``clima_tpu_torch.utils.profiling``: spans,
requests, the marker clock) and the benchmark's arithmetic on its records
(``portbench/metrics/_spans.py``), on the CPU at small sizes; the tests
marked ``cuda`` hold the markers to the card's own timeline (run there with
``python -m pytest --noconftest tests/test_torch_tracing.py -m cuda -s``;
skipped without a card)."""

import inspect
import json
import os
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clima_tpu_torch.ops import cuda_graph, rorr_cuda
from clima_tpu_torch.radtran import radiate
from clima_tpu_torch.tools import profile_stages
from clima_tpu_torch.utils import profiling
from clima_tpu_torch.utils.profiling import records, recording, request, span
from portbench.metrics import _spans
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)

OPACITY_SPANS = ["radtran.opacity"] + [f"radtran.opacity.{s}" for s in (
    "prepare", "kweights", "kdist", "mix", "rayleigh", "absorption", "custom", "particles",
    "combine")]
BENCHMARK_SPANS = ("opacity", "radiate_ir", "radiate_solar", "integrate")


@pytest.fixture(autouse=True)
def _empty_rings():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def workload():
    """The stage tools' bench workload at 2 columns and 10 layers, with the
    haze, and its chain."""
    rad, x = profile_stages.bench_workload(2, 10, torch.device("cpu"), particles=True)
    return rad, x, profile_stages.chain(rad)


def _chain(workload):
    """One radtran call as the benchmark's entry makes it: the opacity, both
    channels, both integrations."""
    rad, x, (opac, ir, solar, _) = workload
    (i0, i1), (s0, s1) = (rad.ir.ind_start, rad.ir.ind_end), (rad.sol.ind_start, rad.sol.ind_end)
    opr = opac(x["P"], x["T"], x["dens"], x["dz"], x["pdens"], x["radii"])
    r_ir, r_sol = ir(opr, x["T_surf"], x["T"]), solar(opr)
    freq = rad.op.freq
    fluxes = (*radiate.integrate_fluxes(r_ir["fup_a"], r_ir["fdn_a"], freq[i0:i1 + 2]),
              *radiate.integrate_fluxes(r_sol["fup_a"], r_sol["fdn_a"], freq[s0:s1 + 2]))
    return opr, r_ir, r_sol, fluxes


def _names():
    return [s["name"] for s in records()["spans"]]


def test_off_records_no_span_and_requests_count(monkeypatch):
    """Off, spans record nothing, while a request still records its host
    stamps and the growth of every counter."""
    monkeypatch.setattr(cuda_graph, "REPLAYS", {"_interval": 5})
    monkeypatch.setattr(rorr_cuda.k_rorr_mix_cuda, "launches", 7)
    with request("adiabat.column_model"):
        with span("t.stage"):
            cuda_graph.REPLAYS["_interval"] += 3
            cuda_graph.REPLAYS["_rk4_interval"] = 2
            rorr_cuda.k_rorr_mix_cuda.launches += 1
    r = records()
    assert r["spans"] == [] and r["dropped"] == 0
    (req,) = r["requests"]
    assert req["name"] == "adiabat.column_model" and req["parent"] is None
    assert req["host_end_ns"] >= req["host_start_ns"] and req["device_start_ns"] is None
    assert req["counters"]["replays"] == {"_interval": 3, "_rk4_interval": 2}
    assert req["counters"]["launches"] == {"k_rorr_mix_cuda": 1}
    assert req["counters"]["captures"] == {} and req["counters"]["warmup_s"] == {}


def test_off_span_allocates_nothing():
    """Off, a span is a shared no-op: once warm, a thousand of them leave no
    allocation behind in the recorder, and the decorator keeps the
    function's name and signature."""
    def stage(a, b=2, *, c=None):
        return a + b

    spanned = span("t.decorated")(stage)
    assert spanned.__name__ == "stage" and spanned(1) == 3
    assert inspect.signature(spanned) == inspect.signature(stage)
    assert span("t.off") is span("t.off")
    with span("t.off"):
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with span("t.off"):
                pass
            spanned(1)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__ and d.size_diff > 0]
    assert grown == [] and records()["spans"] == []


def test_parents_roots_and_self_time():
    """Spans name their parent and their root, the request in which they
    opened; a span's self time is its duration less its children's."""
    with recording():
        with request("adiabat.column_model"):
            with span("t.outer"):
                time.sleep(0.002)
                with span("t.inner"):
                    time.sleep(0.003)
                with span("t.inner"):
                    time.sleep(0.001)
        with span("t.alone"):
            pass
    spans = records()["spans"]
    by = {s["name"]: s for s in spans}
    req, outer, alone = by["adiabat.column_model"], by["t.outer"], by["t.alone"]
    inner = [s for s in spans if s["name"] == "t.inner"]
    assert [s["name"] for s in spans] == ["adiabat.column_model", "t.outer", "t.inner",
                                          "t.inner", "t.alone"]
    assert req["parent"] is None and req["root"] == req["id"]
    assert outer["parent"] == req["id"] and outer["root"] == req["id"]
    assert all(s["parent"] == outer["id"] and s["root"] == req["id"] for s in inner)
    assert alone["parent"] is None and alone["root"] == alone["id"]
    assert records()["requests"][-1]["id"] == req["id"]
    selfs = _spans.self_ns(spans)
    duration = lambda s: s["host_end_ns"] - s["host_start_ns"]
    assert selfs[outer["id"]][0] == duration(outer) - sum(duration(s) for s in inner)
    assert selfs[outer["id"]][0] >= 2e6 and selfs[inner[0]["id"]][0] == duration(inner[0])
    assert selfs[outer["id"]][1] is None  # no markers on the CPU


def test_recording_follows_the_profiler():
    """Spans are recorded while a torch.profiler runs and not before or
    after it, with no record_function range of their own in its trace."""
    a = torch.ones(16, 16)
    with span("t.before"):
        a @ a
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.during"):
            a @ a
    with span("t.after"):
        a @ a
    assert _names() == ["t.during"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::mm" in names and not any(n.startswith("t.") for n in names)


def test_span_contains_the_kineto_event_it_wraps():
    """A span's host stamps are on kineto's clock: they contain the aten::mm
    event launched inside it, within 0.1 ms."""
    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.mm"):
            torch.mm(a, a)
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    (s,) = records()["spans"]
    assert s["host_start_ns"] <= mm.start_ns() + 100_000
    assert s["host_end_ns"] >= mm.start_ns() + mm.duration_ns() - 100_000
    assert mm.start_ns() - s["host_start_ns"] < 50_000_000  # the same clock, not just an order


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    """trace(logdir) writes the program's spans into the Chrome trace it
    exports, on the file's time base, around the aten::mm they wrap."""
    a = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)):
        with span("t.mm"):
            torch.mm(a, a)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    (s,) = [e for e in events if e.get("name") == "t.mm"]
    assert s["tid"] == profiling.HOST_ROW and s["pid"] == os.getpid()
    assert s["ts"] <= mm["ts"] + 100 and s["ts"] + s["dur"] >= mm["ts"] + mm["dur"] - 100
    assert any(e.get("ph") == "M" and e.get("tid") == profiling.DEVICE_ROW for e in events)


def test_radtran_call_span_names(workload):
    """One radtran call records compute_opacity's root and its nine stages,
    each channel's prepare, kernel and finish, and both integrations, under
    none of the benchmark's span names."""
    with recording():
        _chain(workload)
    names = _names()
    assert names == OPACITY_SPANS + [
        "radtran.radiate_ir", "radtran.radiate_ir.prepare", "radtran.radiate_ir.kernel",
        "radtran.radiate_ir.finish", "radtran.radiate_solar", "radtran.radiate_solar.prepare",
        "radtran.radiate_solar.kernel", "radtran.radiate_solar.finish", "radtran.integrate",
        "radtran.integrate"]
    assert not set(names) & set(BENCHMARK_SPANS)
    spans = records()["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["radtran.opacity", "radtran.radiate_ir",
                                          "radtran.radiate_solar", "radtran.integrate",
                                          "radtran.integrate"]
    assert [s["name"] for s in _spans.leaves(spans)] == [
        n for n in names if n not in ("radtran.opacity", "radtran.radiate_ir",
                                      "radtran.radiate_solar")]


def test_outputs_are_bitwise_equal_with_recording_on_and_off(workload):
    off = _chain(workload)
    with recording():
        on = _chain(workload)
    for a, b in zip(off[:3], on[:3]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(off[3], on[3]))


def test_ring_drops_the_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_RING", 4)
    with recording():
        for i in range(10):
            with span(f"t.{i}"):
                pass
    r = records()
    assert [s["name"] for s in r["spans"]] == ["t.6", "t.7", "t.8", "t.9"]
    assert r["dropped"] == 6
    profiling.clear()
    assert records() == dict(spans=[], requests=[], dropped=0)


def test_column_model_request_holds_the_pipeline_spans():
    """A call of make_column_fns' column_model is one request; under
    recording it is the root of the march, the altitude solve, the radtran
    chain and the pipeline's own glue."""
    from clima_tpu_torch.adiabat import AdiabatClimate
    from clima_tpu_torch.data import make_template
    from clima_tpu_torch.parallel.pipeline import make_column_fns

    t = make_template(nz=4, n_zenith=1)
    c = AdiabatClimate(t["species"], t["settings"], t["star"], t["datadir"], substeps=1,
                       device="cpu")
    P_i = np.full(c.sp.ng, 1e-15)
    P_i[c.species_names.index("H2O")] = 270e6
    P_i[c.species_names.index("N2")] = 1e6
    fns = make_column_fns(c)
    T_surf = torch.tensor([280.0, 290.0], dtype=torch.float64)
    P_i_b = torch.tensor(np.stack([P_i, P_i]), dtype=torch.float64)
    off = fns["column_model"](T_surf, P_i_b, c.T_trop)
    assert records()["spans"] == [] and len(records()["requests"]) == 1
    with recording():
        on = fns["column_model"](T_surf, P_i_b, c.T_trop)
        fns["profile_only"](T_surf, P_i_b, c.T_trop)
    assert all(torch.equal(off[k], on[k]) for k in off)
    r = records()
    assert [q["name"] for q in r["requests"]] == ["adiabat.column_model"] * 2 + \
        ["adiabat.profile_only"]
    spans = r["spans"]
    root = spans[0]
    assert root["name"] == "adiabat.column_model" and root["id"] == r["requests"][1]["id"]
    call = [s for s in spans if s["root"] == root["id"]]
    top = [s["name"] for s in call if s["parent"] == root["id"]]
    assert top == ["adiabat.profile", "adiabat.column.layers", "adiabat.altitude",
                   "adiabat.column.amounts", "adiabat.column.grid", "radtran.opacity",
                   "radtran.radiate_ir", "radtran.integrate", "radtran.radiate_solar",
                   "radtran.integrate", "adiabat.column.toa"]
    march = [s["name"] for s in call if s["parent"] == call[1]["id"]]
    nz2 = 2 * 4 + 1
    assert march == ["adiabat.profile.setup", "adiabat.profile.capture"] + \
        ["adiabat.profile.replay"] * (nz2 - 2) + ["adiabat.profile.assemble"]


def _record(i, name, parent, root, h0, h1, d0=None, d1=None):
    return dict(id=i, parent=parent, root=root, name=name, host_start_ns=h0, host_end_ns=h1,
                device_start_ns=d0, device_end_ns=d1, thread=1)


def _synthetic_calls(n):
    """n radtran calls of 3 ms, each: the opacity root with two stages, then
    an integration root. Stage device time 0.5 and 1.0 ms; the stream runs
    dry 0.2 ms before the host enters the second stage and 0.3 ms before it
    enters the integration."""
    spans, i = [], 0
    for k in range(n):
        t = 10_000_000 + 3_000_000 * k
        ms = lambda x: t + int(x * 1e6)
        spans += [_record(i + 1, "radtran.opacity", None, i + 1, ms(0), ms(2.0), ms(0.05), ms(1.7)),
                  _record(i + 2, "radtran.opacity.mix", i + 1, i + 1, ms(0), ms(0.1), ms(0.05),
                          ms(0.55)),
                  _record(i + 3, "radtran.opacity.combine", i + 1, i + 1, ms(0.75), ms(1.0),
                          ms(0.7), ms(1.7)),
                  _record(i + 4, "radtran.integrate", None, i + 4, ms(2.0), ms(2.1), ms(2.0),
                          ms(2.2))]
        i += 4
    return spans


def test_span_arithmetic_on_synthetic_records(monkeypatch):
    """The benchmark's readers on made-up records: the calls of the last
    profiler pass, the stages' marker time, the host wait and the request
    counters, and None wherever nothing was recorded."""
    spans = _synthetic_calls(5)
    rec = dict(spans=spans, dropped=0, requests=[
        dict(_record(90, "adiabat.column_model", None, 90, 0, 1),
             counters=dict(replays={"_interval": 199, "_rk4_interval": 198}, captures={"a": 1,
                           "b": 1}, warmup_s={"_interval": 0.25, "_rk4_interval": 0.05},
                           capture_s={}, launches={}))])
    monkeypatch.setattr(_spans, "program_records", lambda: rec)
    calls = _spans.radtran_calls(spans, 3)
    assert [c[0]["id"] for c in calls] == [9, 13, 17] and all(len(c) == 4 for c in calls)
    assert _spans.radtran_calls(spans, 6) is None
    trace = dict(calls=3)
    assert _spans.stage_ms(trace, ("mix",)) == pytest.approx(0.5)
    assert _spans.stage_ms(trace, ("mix", "combine")) == pytest.approx(1.5)
    assert _spans.stage_ms(trace, ("rayleigh",)) is None
    # mix ends on the device at 0.55 ms, the host enters combine at 0.75: 0.2;
    # combine ends at 1.7, the integration starts at 2.0: 0.3
    assert _spans.host_wait_ms(calls) == pytest.approx(0.5)
    assert _spans.self_ns(spans)[1] == (2_000_000 - 100_000 - 250_000, 1_650_000 - 1_500_000)
    load = lambda name: __import__("portbench.run", fromlist=["_load"])._load(
        os.path.join(os.path.dirname(_spans.__file__), name + ".py"), "t_" + name.replace(".", "_"))
    assert load("opacity_mix_ms").read(trace) == pytest.approx(0.5)
    assert load("host_wait_ms.radtran").read(trace) == pytest.approx(0.5)
    assert load("opacity_ktables_ms").read(trace) is None
    adiabat = dict(calls=1, counters=dict(capture_s=0.3))
    assert load("graph_replays_per_call.adiabat").read(adiabat) == 397
    assert load("captures_per_call.adiabat").read(adiabat) == 2
    assert load("capture_warmup_ms_per_call").read(adiabat) == pytest.approx(300.0)
    assert load("captures_per_call.adiabat").read(dict(calls=1)) is None
    unmarked = [dict(s, device_end_ns=None) for s in spans]
    assert _spans.host_wait_ms(_spans.radtran_calls(unmarked, 3)) is None
    monkeypatch.setattr(_spans, "program_records", lambda: None)
    assert load("opacity_mix_ms").read(trace) is None
    assert load("graph_replays_per_call.adiabat").read(adiabat) is None


def test_no_program_span_is_named_after_a_benchmark_span_or_uses_record_function():
    root = os.path.dirname(os.path.dirname(profiling.__file__))
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(d, f)).read()
                assert "record_function(" not in src, f
                for name in BENCHMARK_SPANS:
                    assert f'span("{name}")' not in src and f'request("{name}")' not in src, f


# ------------------------------------------------------------------ card


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_markers_share_the_host_clock_and_counters_count(dev):
    """After a sync, a span's start marker lands within 50 us of its host
    start; a graphed function counts its capture, warm-up and replays, and
    the warm-up is a span on the side stream."""
    x = torch.ones(1024, device=dev)
    fn = lambda a: (a * 2.0 + 1.0,)  # noqa: E731
    torch.cuda.synchronize()
    with recording():
        for _ in range(5):
            torch.cuda.synchronize()
            with span("t.idle"):
                x.add_(1.0)
        with request("t.request"):
            replay, _ = cuda_graph.graphed(fn, x)
            for _ in range(3):
                replay(x)
    r = records()
    lags = [s["device_start_ns"] - s["host_start_ns"] for s in r["spans"] if s["name"] == "t.idle"]
    print("marker start - host start (us):", [round(v / 1e3, 1) for v in lags])
    assert all(-50_000 < v < 50_000 for v in lags[1:]), lags
    growth = r["requests"][-1]["counters"]
    assert growth["captures"] == {"<lambda>": 1} and growth["replays"] == {"<lambda>": 3}
    assert growth["warmup_s"]["<lambda>"] > 0
    (warm,) = [s for s in r["spans"] if s["name"] == "ops.cuda_graph.warmup"]
    assert warm["device_end_ns"] >= warm["device_start_ns"] > 0


@pytest.mark.cuda
def test_card_leaves_hold_every_kernel_and_tile_the_call(dev):
    """In a traced radtran call (1024 columns and 202 layers, the size of the
    benchmark's earth_radtran.c1024) every kernel the profiler records was
    launched inside one of the program's leaf spans, and each root's leaves
    with its two edges cover its marker interval within 2 %."""
    from torch.autograd import DeviceType

    rad, x = profile_stages.bench_workload(1024, 202, dev)
    chain = profile_stages.chain(rad)
    w = (rad, x, chain)
    x["pdens"] = x["radii"] = None
    _chain(w)
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _chain(w)
        torch.cuda.synchronize()
    spans = records()["spans"]
    leaves = _spans.leaves(spans)
    events = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != DeviceType.CUDA and e.name().startswith(("cuda", "cu"))}
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA]
    assert kernels
    host = {e.correlation_id(): e for e in events if e.device_type() != DeviceType.CUDA}

    def opened_at(t):
        return [s["name"] for s in spans if s["host_start_ns"] <= t <= s["host_end_ns"]]

    outside = [(e.name()[:60], host[e.linked_correlation_id()].name()
                if e.linked_correlation_id() in host else None,
                opened_at(launch.get(e.correlation_id(), -1)))
               for e in kernels
               if not any(s["host_start_ns"] <= launch.get(e.correlation_id(), -1)
                          <= s["host_end_ns"] for s in leaves)]
    assert outside == [], outside[:5]
    for root in (s for s in spans if s["parent"] is None):
        kids = sorted((s for s in leaves if s["root"] == root["id"]),
                      key=lambda s: s["device_start_ns"])
        whole = root["device_end_ns"] - root["device_start_ns"]
        if not kids:
            continue
        covered = sum(s["device_end_ns"] - s["device_start_ns"] for s in kids)
        covered += kids[0]["device_start_ns"] - root["device_start_ns"]
        covered += root["device_end_ns"] - kids[-1]["device_end_ns"]
        print(f"{root['name']}: marker {whole / 1e6:.3f} ms, leaves and edges "
              f"{covered / 1e6:.3f} ms")
        assert abs(covered - whole) <= 0.02 * whole, root["name"]


@pytest.mark.cuda
def test_card_span_cost(dev):
    """Host cost of a span, off and on (markers included), printed; on a
    card both are a few microseconds at most."""
    x = torch.ones(16, device=dev)
    x.add_(1.0)
    torch.cuda.synchronize()

    def per_span(n=20000):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("t.cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = min(per_span() for _ in range(3))
    with recording():
        per_span(100)
        on = min(per_span(5000) for _ in range(3))
    records()
    print(f"span host cost: off {off:.3f} us, on {on:.3f} us "
          f"({torch.cuda.get_device_name(dev)})")
    assert off < 2.0 and on < 50.0
