"""Run one cell of the benchmark on the card and print its result line.

    python -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``clima_tpu_torch``). The cell's configuration, traffic mix,
entry module, limits and metric readers are found by the names in
``BENCHMARK.json``: ``portbench/configs/<config>.json``,
``portbench/traffic/<traffic>.json``, ``portbench/entries/<entry>.py`` (the
configuration names its entry), ``portbench/limits/<workload>.json``,
``portbench/end_to_end/<metric>.py`` and ``portbench/metrics/<metric>.py``.

A run: set-up (imports, the template, the model, the inputs from the seed
on the device, the warm-up of the cell's one shape), then batch calls in a
closed loop, each closed by a device sync, until ``--seconds`` have passed
(the call in flight then finishes, so the window holds whole calls), then
with ``--trace 1`` the traced calls, then the comparison of the kept answers
with the plain reference. The last line of standard output is the result;
the numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "clima_tpu")

__all__ = ["main", "verdict", "forbidden_modules", "cell_files", "entry_of"]


def forbidden_modules():
    """Top-level names of loaded modules that a run may not hold, compared
    whole (``clima_tpu_torch`` is not ``clima_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell_files(workload, overrides=None):
    """(BENCHMARK.json, the workload's entry, its configuration, its traffic
    mix, its limits), found by name; ``overrides`` ({"config": {...},
    "traffic": {...}}) replaces keys of the configuration and the mix. A
    workload that BENCHMARK.json does not name raises KeyError."""
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(workload)
    config = _json(os.path.join(ROOT, next(c["file"] for c in bench["configs"]
                                           if c["name"] == cell["config"])))
    mix = _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", cell["name"] + ".json"))
    config.update((overrides or {}).get("config", {}))
    mix.update((overrides or {}).get("traffic", {}))
    return bench, cell, config, mix, limits


def entry_of(config):
    """The entry module that drives the configuration (``entries/<entry>.py``)."""
    return _load(os.path.join(HERE, "entries", config["entry"] + ".py"),
                 "portbench_entry_" + config["entry"])


def verdict(per_call, limits):
    """The comparison that decides ``correct``: each number's worst value
    over the kept calls against its limit. ``per_call`` is {number: its
    value in each kept call}. Returns (numbers {number: worst value}, the
    kept calls that fail a limit, correct)."""
    numbers = {k: float(max(v)) for k, v in per_call.items()}
    kept_calls = len(next(iter(per_call.values())))
    failed = sum(any(not (per_call[k][j] <= limits[k]) for k in per_call)
                 for j in range(kept_calls))
    correct = all(v <= limits[k] for k, v in numbers.items()) and failed == 0
    return numbers, int(failed), bool(correct)


def _card(torch, device):
    """The device's fields of the result line, and the card's power limit."""
    limit = None
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                                f"--id={device.index or 0}"], capture_output=True, text=True,
                               timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)),
                power_limit=limit)


def main(argv=None, device=None, overrides=None):
    """Run a cell; returns the exit code. ``device`` (a torch.device) skips
    the look for a card, and ``overrides`` ({"config": {...}, "traffic":
    {...}}) replaces keys of the cell's files: both serve the tests, which
    drive a run on the CPU at a small size."""
    ap = argparse.ArgumentParser(prog="python -m portbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        bench, cell, config, mix, limits = cell_files(args.workload, overrides)
    except KeyError:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run = entry_of(config).Cell(config, mix, args.seed, device)
    t_setup = time.perf_counter()
    run.setup()
    setup_s = time.perf_counter() - T_START
    builds = {}
    if device.type == "cuda":
        from clima_tpu_torch.ops import cuda_build
        builds = {k: v["seconds"] for k, v in cuda_build.BUILD_INFO.items()}
    print(f"setup {setup_s:.3f} s: imports and files {t_setup - T_START:.3f} s, "
          + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items())
          + f"; nvcc builds (s, 0 when reused): {builds}", file=sys.stderr)

    latencies, columns, calls = [], 0, 0
    t_window = time.perf_counter()
    deadline = t_window + args.seconds
    while True:
        t0 = time.perf_counter()
        columns += run.call(calls)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        calls += 1
        if t1 >= deadline:
            break
    window = dict(setup_s=setup_s, columns=columns, calls=calls, window_s=t1 - t_window,
                  latencies_s=latencies)
    ms = sorted(1e3 * x for x in latencies)
    print(f"window {calls} calls in {window['window_s']:.3f} s; call ms min {ms[0]:.3f} median "
          f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}"
          + (f"; each {[round(1e3 * x, 1) for x in latencies]}" if calls <= 20 else ""),
          file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    trace = run.trace(calls, window["window_s"]) if args.trace else None
    dev = _card(torch, device) if device.type == "cuda" else dict(
        platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    run.release()

    per_call, compared = run.check(calls)
    numbers, failed, correct = verdict(per_call, limits)

    wanted = lambda m: "workloads" not in m or cell["name"] in m["workloads"]
    metrics, breakdown = {}, None
    if args.trace:
        dev.update(busy_s=trace.get("busy_s"), window_s=trace["window_s"])
        print("trace " + json.dumps({k: v for k, v in trace.items()
                                      if k not in ("kernels", "breakdown")}), file=sys.stderr)
        for m in filter(wanted, bench["per_layer"]):
            value = _load(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "portbench_metric_" + m["name"].replace(".", "_")).read(trace)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        breakdown = trace.get("breakdown") or _breakdown(trace)
    else:
        for m in filter(wanted, bench["end_to_end"]):
            value = _load(os.path.join(HERE, "end_to_end", m["name"] + ".py"),
                          "portbench_e2e_" + m["name"]).read(window)
            metrics[m["name"]] = dict(value=value, unit=m["unit"])

    found = forbidden_modules()
    if found:
        print(f"loaded by the run: {', '.join(found)}", file=sys.stderr)
        return 4
    result = dict(correct=correct, attempted=calls, failed=failed, metrics=metrics, device=dev)
    if breakdown:
        result["breakdown"] = breakdown
    result["nvcc_build_s"] = sum(builds.values())
    result["check"] = {k: dict(value=v, limit=limits[k]) for k, v in numbers.items()}
    result["check"]["answers_compared"] = compared
    for k, v in numbers.items():
        print(f"check {k} {v!r} limit {limits[k]!r}", file=sys.stderr)
    print(f"check answers_compared {compared} correct {correct}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _breakdown(trace):
    """The device operations that took most time and the idle gaps by the
    benchmark span the host was in, ten each, from a profiler trace."""
    if "kernels" not in trace:
        return None
    from portbench.metrics import _trace

    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(trace.get("gaps", {}).items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[_trace.short_name(name), s] for name, (s, _) in ops],
                idle_gaps=[[name, s] for name, s in gaps])


if __name__ == "__main__":
    sys.exit(main())
