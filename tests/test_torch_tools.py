"""The port's card-facing tools (clima_tpu_torch.tools) on the CPU.

- ``roofline``: each kernel's byte and operation counts against hand counts
  at a small shape, and the bounds at the flagship shapes against the
  values chip_smoke.py printed before the counts moved there (#5 also at 12
  zenith angles); the bound is the larger of its two terms.
- ``rce_bench --device cpu --sizes 2 --nz 6`` (at 1 substep) and
  ``scaling --device cpu --devices 1 --workloads toa --nz 6 --iters 1``
  write their JSON with the documented fields, every lane at status 0 and
  the rank's exit code 0.
- ``validation`` compares the card with the CPU, and says so where there is
  no card; its run on the card is in tests/test_torch_cuda.py.
- Every tool and example raises without a card unless asked for the CPU.
"""

import json

import pytest
import torch

from clima_tpu_torch.examples import (climate_evolve, early_mars, modern_earth_radtran,
                                      tutorial_adiabat_climate)
from clima_tpu_torch.tools import rce_bench, roofline, scaling, validation
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


def test_roofline_counts_match_hand_counts():
    """64 rows x 10 layers, 8 gauss points, 3 zenith angles; RORR over 100
    lanes of 3 species at nbin 4. Bytes are float64 items x 8."""
    rows, nz, nG = 64, 10, 8
    # tau, w0, gt + emissivity + bplanck + wbin in; fup, fdn per gauss group out
    assert roofline.ir_weighted_work(rows, nz, nG) == (
        8 * (3 * 640 + 64 + 64 * 11 + 8 + 2 * 8 * 11), 640 * 83)
    # tau, w0, gt + Rsfc + u0s, zw + wbin in; fup, fdn (and amean) per group out
    assert roofline.solar_weighted_work(rows, nz, 3, nG) == (
        8 * (3 * 640 + 64 + 6 + 8 + 2 * 8 * 11), 640 * (25 + 75 + 25 + 3 * 28))
    assert roofline.solar_weighted_work(rows, nz, 3, nG, amean=True) == (
        8 * (3 * 640 + 64 + 6 + 8 + 3 * 8 * 11), 640 * (25 + 75 + 25 + 3 * 38))
    # tau (3, 4, 100) + wbin + wbin_e in, (4, 100) out; 2 pairs x 16 keys x
    # (sum, sort log2 16 = 4, prefix, 2 rebin)
    assert roofline.rorr_work(100, 4) == (8 * (1200 + 400 + 8 + 1), 2 * 100 * 16 * 8)
    # #4: tau, w0, gt + emissivity + bplanck in; fup, fdn per row out
    assert roofline.ir_work(rows, nz) == (8 * (3 * 640 + 64 + 64 * 11 + 2 * 64 * 11), 640 * 83)
    # #5 at 12 zeniths: tau, w0, gt + Rsfc + u0s in; amean, fup, fdn per
    # (zenith, row) and the surface radiance out
    assert roofline.solar_multi_work(rows, nz, 12) == (
        8 * (3 * 640 + 64 + 12 + 3 * 12 * 64 * 11 + 12 * 64),
        640 * (25 + 300 + 25 + 12 * 38))
    # #6: tau, w0, gt + u0, Rsfc in; amean, fup, fdn + surface radiance out
    assert roofline.solar_work(rows, nz) == (8 * (3 * 640 + 128 + 3 * 64 * 11 + 64),
                                             640 * (25 + 25 + 25 + 38))


def test_roofline_bounds_at_the_flagship_shapes():
    """The bounds chip_smoke.py printed for phases 3a and 3b before it took
    its counts from tools/roofline.py (ms, to the printed digits)."""
    got = {
        "#1": roofline.bound(*roofline.ir_weighted_work(256 * 28 * 8, 202, 8)),
        "#2": roofline.bound(*roofline.solar_weighted_work(256 * 32 * 8, 202, 4, 8)),
        "RORR": roofline.bound(*roofline.rorr_work(256 * 51 * 202, 8)),
        "#4": roofline.bound(*roofline.ir_work(122880, 202)),
        "#5": roofline.bound(*roofline.solar_multi_work(122880, 202, 4)),
        "#5 at 12": roofline.bound(*roofline.solar_multi_work(122880, 202, 12)),
        "#6": roofline.bound(*roofline.solar_work(122880, 202)),
    }
    want = {"#1": 0.118, "#2": 0.103, "RORR": 0.202, "#4": 0.357, "#5": 0.894,
            "#5 at 12": 2.326, "#6": 0.357}
    for k, ms in want.items():
        assert round(got[k][0], 3) == ms and got[k][1] == "bytes", k


def test_roofline_bound_is_the_larger_term():
    assert roofline.bound(3.35e9, 0.0) == (1.0, "bytes")
    assert roofline.bound(0.0, 34e9) == (1.0, "operations")
    assert roofline.bound(3.35e9, 68e9) == (2.0, "operations")
    assert roofline.bound(6.7e9, 34e9) == (2.0, "bytes")


def test_rce_bench_on_the_cpu_writes_its_json(tmp_path):
    out = tmp_path / "rce_bench.json"
    res = rce_bench.main(["--device", "cpu", "--sizes", "2", "--nz", "6", "--substeps", "1",
                          "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert {"device", "nz", "substeps", "xtol_rc", "flux_precision", "warm_start",
            "runs"} <= set(res)
    (run,) = res["runs"]
    assert {"B", "first", "second", "columns_per_s_with_capture",
            "columns_per_s_without_capture", "converged_frac", "status",
            "status_counts", "max_ratio_max", "ratio_floor_max", "solve_iters", "rc_iters",
            "T_surf_range", "finite"} <= set(run)
    assert run["B"] == 2 and run["status"] == [0, 0] and run["finite"]
    assert run["max_ratio_max"] < 1e-5
    assert {"wall_s", "capture_s", "rest_s", "captures", "launches"} <= set(run["second"])
    assert run["second"]["captures"] == 0  # no CUDA graph on the CPU
    assert run["columns_per_s_with_capture"] == 2 / run["second"]["wall_s"]
    assert run["columns_per_s_without_capture"] == 2 / run["second"]["rest_s"]


def test_scaling_on_the_cpu_writes_its_json(tmp_path):
    out = tmp_path / "scaling.json"
    (rec,) = scaling.main(["--device", "cpu", "--devices", "1", "--workloads", "toa", "--nz", "6",
                           "--iters", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == [json.loads(json.dumps(rec))]
    assert {"workload", "devices", "columns", "iters", "wall_s_median", "wall_s_iqr",
            "columns_per_s", "efficiency_vs_1dev", "efficiency_spread_est", "rank_exitcodes",
            "launches"} <= set(rec)
    assert rec["workload"] == "toa" and rec["devices"] == 1 and rec["columns"] == 8
    assert rec["backend"] == "gloo" and rec["rank_exitcodes"] == [0]
    assert rec["wall_s_median"] > 0 and rec["efficiency_vs_1dev"] == 1.0


def test_validation_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="compares the CUDA card with the CPU"):
        validation.main(["--nz", "6"])


@pytest.mark.parametrize("name", ["roofline", "rce_bench", "scaling", "modern_earth_radtran",
                                  "tutorial_adiabat_climate", "early_mars", "climate_evolve"])
def test_entry_points_raise_without_a_card(monkeypatch, name):
    """Without a card and without device="cpu" each tool and example raises
    (it never falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    examples = {m.__name__.rsplit(".", 1)[1]: m for m in (
        modern_earth_radtran, tutorial_adiabat_climate, early_mars, climate_evolve)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if name in examples:
            examples[name].main(nz=4)
        else:
            {"roofline": roofline, "rce_bench": rce_bench, "scaling": scaling}[name].main([])


def test_validation_kernel_parity_names_every_output_on_the_cpu():
    """On CPU tensors each wrapper runs its twin, so every difference is 0;
    the outputs include the solar kernels' surface radiance, and the twin's
    own two solves part by less than each fixed limit."""
    parity = validation.kernel_parity(torch.device("cpu"))
    outputs = {f"{k}_{o}" for k, os_ in (("solar", ("amean", "surfrad", "fup", "fdn")),
                                         ("solar_multi", ("amean", "surfrad", "fup", "fdn")),
                                         ("ir", ("fup", "fdn"))) for o in os_}
    assert set(parity) == {f"{o}_maxrel" for o in outputs} | {f"{o}_floor" for o in outputs} \
        | {"rorr_maxrel"}
    ok, limits = validation.parity_within(parity)
    assert ok and all(v == 0.0 for k, v in parity.items() if k.endswith("_maxrel"))
    assert all(parity[f"{o}_floor"] < limits[f"{o}_maxrel"] for o in outputs)


def test_validation_limits_are_fixed():
    """The parity limits do not follow the twin's spread, and the device RCE
    is held to RCE_LIMITS."""
    parity = dict(ir_fup_maxrel=1.9e-9, ir_fup_floor=1e-6, solar_surfrad_maxrel=1.1e-9,
                  solar_surfrad_floor=1e-6, rorr_maxrel=0.0)
    ok, limits = validation.parity_within(parity)
    assert limits == dict(ir_fup_maxrel=2e-9, solar_surfrad_maxrel=1e-9, rorr_maxrel=1e-9)
    assert not ok
    rec = dict(status=[0, 0], converged=[True, True],
               vs_cpu_f64=dict(mask_equal=True, dT_surf_K=-4e-3, dT_max_K=9e-2))
    assert validation.rce_within(rec, True) and not validation.rce_within(rec, False)
    for key, value in (("dT_surf_K", 6e-3), ("dT_max_K", 0.11), ("mask_equal", False)):
        bad = dict(rec, vs_cpu_f64=dict(rec["vs_cpu_f64"], **{key: value}))
        assert not validation.rce_within(bad, True), key
    assert not validation.rce_within(dict(rec, status=[0, 2]), True)
