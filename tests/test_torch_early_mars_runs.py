"""Small-size CPU runs of the benchmark's cell ``early_mars_adiabat.co2_sweep.c1024``,
as ``portbench/tests/test_portbench_runs.py`` runs the others: its sound run
against the plain reference, its three planted faults (``unchanged_state``,
``half_batch``, ``altered_answer``) and its float32 control, which have to
come out not correct. The cell is cut to its own settings at nz 5 (the
harness's ``small()`` would give it the Earth template's), and its sound run
is also traced, where the recorded entry's per-column metric reads the
march's event counter.

The runs go in one child process: the harness refuses to run beside the JAX
package, which this suite's conftest loads."""

import contextlib
import copy
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARS = "early_mars_adiabat.co2_sweep.c1024"
FAULTS = ("unchanged_state", "half_batch", "altered_answer")
CPU = torch.device("cpu")


def overrides():
    """The cell cut to a size a CPU test can hold."""
    with open(os.path.join(ROOT, "portbench", "configs", "early_mars_adiabat.json")) as f:
        settings = copy.deepcopy(json.load(f)["settings"])
    settings["atmosphere-grid"]["number-of-layers"] = 5
    return dict(config={"settings": settings, "radiative_layers": 12, "substeps": 2},
                traffic={"columns_per_call": 4, "checked_columns": 64})


def _run(seed, seconds, trace=0):
    from portbench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", MARS, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=CPU, overrides=overrides())
    lines = out.getvalue().strip().splitlines()
    return dict(rc=rc, line=json.loads(lines[-1]) if rc == 0 else None,
                err_last=err.getvalue().strip().splitlines()[-1])


def child():
    """Every run of the cell, in this process: one JSON line of results."""
    from portbench import control, run
    from portbench.tests.test_portbench_runs import FAULTS as PLANTED

    torch.set_num_threads(1)
    res = dict(sound=_run(3_000_000_019, 0.5), traced=_run(3_000_000_019, 0.5, trace=1),
               forbidden=run.forbidden_modules())
    for fault in FAULTS:
        saved = []
        for module, name, broken in PLANTED["adiabat"][fault]():
            saved.append((module, name, getattr(module, name)))
            setattr(module, name, broken)
        try:
            res[fault] = _run(3_000_000_023, 2.0)
        finally:
            for module, name, fn in saved:
                setattr(module, name, fn)
    res["control"] = {str(dt): control.reading(MARS, 3_000_000_029, 0.5, dt, CPU, overrides())
                      for dt in (torch.float32, torch.float64)}
    print(json.dumps(res))


@pytest.fixture(scope="module")
def results():
    """The cell's runs, in a child process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", "import test_torch_early_mars_runs as t; t.child()"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_sound_run_matches_the_reference(results):
    res = results
    assert res["sound"]["rc"] == 0 and res["forbidden"] == []
    line = res["sound"]["line"]
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    numbers = {k: v["value"] for k, v in line["check"].items() if k != "answers_compared"}
    assert max(numbers.values()) < 1e-11, numbers
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert res["sound"]["err_last"].startswith("check answers_compared")
    traced = res["traced"]["line"]
    assert traced["correct"]
    assert traced["metrics"]["march_event_splits_per_column"]["value"] > 0
    assert "march_kernel_ms" not in traced["metrics"]  # no device markers on the CPU


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_not_correct(results, fault):
    res = results[fault]
    assert res["rc"] == 0 and res["line"]["attempted"] >= 2
    assert not res["line"]["correct"], res["line"]["check"]


def test_control_fails_the_limits(results):
    f32, f64 = (results["control"][str(dt)] for dt in (torch.float32, torch.float64))
    assert not f32["correct"] and f32["failed"] >= 1, f32
    assert f64["correct"] and f64["failed"] == 0, f64
