"""Readings of a cell's compared numbers, from which its limits are set.

    python -m portbench.control --workload NAME --seconds S
        [--program-seeds N ...] [--control-seeds N ...]

For each program seed, the program as the configuration states it (float64);
for each control seed, the control: the same program on its own float32 path
(both constructors take ``dtype``), the nearest precision below the one the
configuration states. Each reading is a short window of the cell's own
traffic at its own size, then the comparison of its kept answers with the
float64 reference and the verdict, exactly as a run makes them
(``run.verdict``): a control reading has to come out not correct. All
readings run in one
process, one after another, and each prints a JSON line. A control reading
that crashes or gives a non-finite number has failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import run as bench_run

__all__ = ["reading", "main"]


def reading(workload, seed, seconds, dtype, device, overrides=None):
    """The compared numbers of one short window of ``workload`` with the
    program in ``dtype``, judged by the run's own comparison with the cell's
    limits: dict(seed, dtype, calls, numbers, failed, correct)."""
    _, _, config, mix, limits = bench_run.cell_files(workload, overrides)
    cell_run = bench_run.entry_of(config).Cell(config, mix, seed, device, dtype=dtype)
    cell_run.setup()
    calls, deadline = 0, time.perf_counter() + seconds
    while True:
        cell_run.call(calls)
        calls += 1
        if time.perf_counter() >= deadline:
            break
    cell_run.release()
    per_call, _ = cell_run.check(calls)
    numbers, failed, correct = bench_run.verdict(per_call, limits)
    return dict(seed=seed, dtype=str(dtype).replace("torch.", ""), calls=calls,
                numbers=numbers, failed=failed, correct=correct)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.control",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for seeds, dtype in ((args.program_seeds, torch.float64), (args.control_seeds, torch.float32)):
        for seed in seeds:
            try:
                rec = reading(args.workload, seed, args.seconds, dtype, device)
            except (RuntimeError, ValueError, FloatingPointError) as exc:
                rec = dict(seed=seed, dtype=str(dtype), correct=False,
                           crashed=f"{type(exc).__name__}: {exc}")
            print(json.dumps(dict(workload=args.workload, **rec)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
