"""A run of each cell on the CPU at a small size: the port (its plain twins
here) against the plain reference, the result line, and the faults that the
comparison has to catch."""

import json

import pytest
import torch

import clima_tpu_torch.parallel.pipeline as pipeline
import clima_tpu_torch.radtran.opacity as opacity
import clima_tpu_torch.radtran.radiate as radiate
from portbench import run
from portbench.tests.conftest import WORKLOADS, small

CPU = torch.device("cpu")


def _run(capsys, workload, seed=3_000_000_019, seconds=0.5, trace=0):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device=CPU, overrides=small(workload))
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_matches_the_reference(capsys, workload):
    line, err = _run(capsys, workload)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    numbers = {k: v["value"] for k, v in line["check"].items() if k != "answers_compared"}
    assert max(numbers.values()) < 1e-11, numbers
    assert list(line["check"])[-1] == "answers_compared" and list(line)[-1] == "check"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert err.strip().splitlines()[-1].startswith("check answers_compared")
    assert run.forbidden_modules() == []


def _stale(fn):
    """A step that returns its first result whatever its inputs."""
    first = []

    def stale(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]
    return stale


def _half_batch(fn, column_args):
    """The step computed on the first half of the columns, repeated."""
    def half(*a, **k):
        a = list(a)
        B = a[column_args[0]].shape[0]
        for i in column_args:
            if a[i] is not None:
                a[i] = a[i][: B // 2]
        out = fn(*a, **k)
        tile = lambda x: torch.cat([x, x])[:B] if torch.is_tensor(x) and x.ndim and \
            x.shape[0] == B // 2 else x
        return {key: tile(v) for key, v in out.items()} if isinstance(out, dict) else tile(out)
    return half


def _altered(fn):
    """Every answer's upward flux perturbed by a relative 1e-6 where it is made."""
    def altered(fup_a, fdn_a, freq):
        fup, fdn = fn(fup_a, fdn_a, freq)
        return fup * (1.0 + 1e-6), fdn
    return altered


FAULTS = {
    "radtran": {"unchanged_state": lambda: [(opacity, "compute_opacity",
                                             _stale(opacity.compute_opacity))],
                "half_batch": lambda: [(opacity, "compute_opacity",
                                        _half_batch(opacity.compute_opacity, (1, 2, 3, 4, 5, 6)))],
                "altered_answer": lambda: [(radiate, "integrate_fluxes",
                                            _altered(radiate.integrate_fluxes))]},
    "adiabat": {"unchanged_state": lambda: [(pipeline, "make_profile_core",
                                             _stale(pipeline.make_profile_core))],
                "half_batch": lambda: [(pipeline, "make_profile_core",
                                        _half_batch(pipeline.make_profile_core, (2, 3)))],
                "altered_answer": lambda: [(pipeline, "integrate_fluxes",
                                            _altered(pipeline.integrate_fluxes))]},
}


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_planted_fault_is_not_correct(capsys, monkeypatch, workload, fault):
    """The rest of a run, with the timed path broken underneath: correct is
    false. (One card: no exchange between chips to leave out.)"""
    kind = "adiabat" if "adiabat" in workload else "radtran"
    for module, name, broken in FAULTS[kind][fault]():
        monkeypatch.setattr(module, name, broken)
    line, _ = _run(capsys, workload, seed=3_000_000_023, seconds=2.0)
    assert line["attempted"] >= 2
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits(workload):
    """The control, the program on its float32 path, comes out not correct
    by the run's own verdict, and the program in float64 correct."""
    from portbench import control

    rec = control.reading(workload, 3_000_000_029, 0.5, torch.float32, CPU, small(workload))
    assert not rec["correct"] and rec["failed"] >= 1, rec
    rec = control.reading(workload, 3_000_000_029, 0.5, torch.float64, CPU, small(workload))
    assert rec["correct"] and rec["failed"] == 0, rec


def test_cuda_run_without_a_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""
