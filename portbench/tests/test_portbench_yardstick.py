"""The benchmark's own yardstick: the copied roofline counts, the profiler
arithmetic, the readers, and what the harness may import."""

import ast
import os
import types

import pytest

from portbench import run
from portbench.metrics import _roofline, _trace

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("work, bound_ms", [
    (_roofline.ir_weighted_work(57344, 202, 8), 0.118),         # #1 at phase 3's shapes
    (_roofline.solar_weighted_work(65536, 202, 4, 8), 0.103),   # #2
    (_roofline.rorr_work(2637312, 8, 3), 0.202),                # RORR
])
def test_roofline_bounds_at_phase3_shapes(work, bound_ms):
    ms, by = _roofline.bound(*work)
    assert round(ms, 3) == bound_ms and by == "bytes"


def test_busy_union_merges_overlaps():
    assert _trace.busy_union([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-9)
    assert _trace.busy_union([]) == 0.0


class _Event:
    def __init__(self, name, device, start, dur, corr=0, linked=0):
        self._v = (name, device, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _profile(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_read_profile_attributes_kernels_to_spans_and_guards_lost_records():
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [_Event("opacity", cpu, 0, 100, corr=1),
              _Event("cudaLaunchKernel", cpu, 10, 5, corr=2),
              _Event("radiate_ir", cpu, 100, 100, corr=3),
              _Event("cudaLaunchKernel", cpu, 120, 5, corr=4),
              _Event("void rorr_chain_kernel<double, 8, 64, 8>(double const*)", gpu, 50, 40,
                     linked=1),
              _Event("void ir_weighted_kernel<double>(double const*)", gpu, 130, 20, linked=3),
              _Event("radiate_ir", gpu, 110, 60)]  # the profiler's device copy of a span
    r = _trace.read_profile(_profile(events), ("opacity", "radiate_ir"))
    assert r["ok"] and r["launch_calls"] == 2 and r["kernel_records"] == 2
    assert r["span_busy_s"] == {"opacity": 40e-9, "radiate_ir": 20e-9}
    assert r["gaps"] == {"radiate_ir": 40e-9} and r["busy_s"] == 60e-9
    lost = _trace.read_profile(_profile(events[:-2]), ("opacity", "radiate_ir"))
    assert not lost["ok"]


def _read(name, trace):
    return run._load(os.path.join(PB, "metrics", name + ".py"), "m_" + name.replace(".", "_")) \
        .read(trace)


def test_readers_return_nothing_where_nothing_was_read():
    for name in os.listdir(os.path.join(PB, "metrics")):
        if name.endswith(".py") and not name.startswith("_"):
            assert _read(name[:-3], dict(calls=1, window_s=1.0, shapes={}, kernels={})) is None


def test_kernel_roofline_reader():
    bound_s = _roofline.bound(*_roofline.rorr_work(2637312, 8, 3))[0] / 1e3
    trace = dict(calls=2, kernels={"void rorr_chain_kernel<double, 8, 64, 8>(x)": [4 * bound_s, 2]},
                 shapes=dict(rorr_lanes=2637312, nbin=8, nk=3))
    assert _read("rorr_roofline_pct", trace) == pytest.approx(50.0, rel=1e-3)


def _imports(path):
    """Top-level names of every module a file imports, compared whole."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _files(*parts):
    top = os.path.join(PB, *parts)
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")]


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    for path in _files():
        assert not _imports(path) & {"jax", "jaxlib", "flax", "clima_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        assert not _imports(path) & {"jax", "clima_tpu", "clima_tpu_torch"}, path


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "clima_tpu_torch_like", types.ModuleType("x"))
    assert "clima_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "clima_tpu.ops", types.ModuleType("x"))
    assert run.forbidden_modules() == ["clima_tpu"]
