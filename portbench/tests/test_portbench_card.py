"""Each cell for a few seconds on the card, as the benchmark runs it, in a
process of its own (run there with ``-m cuda``; skipped without a card)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.tests.conftest import ROOT, WORKLOADS


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                          "--seed", "3000000041", "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]
    if trace:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]
