"""The split compute_opacity and the stage tools of the port
(clima_tpu_torch.tools.{profile_stages,opacity_substages,rorr_crossover}).

- compute_opacity's stages against their JAX counterparts on the same numpy
  inputs (float64, rtol 1e-12): ``_interp_ktable`` per species against
  ``clima_tpu.radtran.opacity._interp_ktable``, and the mix of the stage
  chain's own species tensor against ``clima_tpu.ops.rorr.k_rorr_mix``;
- each tool on the CPU at a small size (2 columns of the template at 4
  layers, 10 radiative layers; RORR chains of 4 x 6 lanes): every stage or
  nbin present, times finite and positive, no launches, the composed stages
  bitwise equal to compute_opacity, the kernel's twin within 1e-9 of the
  sort path; and each raises without a card unless asked for the CPU;
- the three tools small on the card (``cuda``; skips here).

The JAX package is imported inside the tests that use it: on a GPU machine
``python -m pytest --noconftest tests/test_torch_stage_tools.py -m cuda``.
"""

import json

import numpy as np
import pytest
import torch

from clima_tpu_torch.tools import opacity_substages, profile_stages, rorr_crossover
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)

NZ = 10  # radiative layers of the tools' template (its nz 4)
SMALL = ["--device", "cpu", "--columns", "2", "--nz", str(NZ), "--iters", "2"]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The JAX package's template tables at nz 12 and the port's copy, with
    three jittered columns (ground-up) from a seed."""
    from clima_tpu.config import load_settings, load_species
    from clima_tpu.data import make_template_dir
    from clima_tpu.radtran import data as ref_data
    from clima_tpu_torch.radtran import optical_data_from_numpy

    nz = 12
    t = make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=nz, n_zenith=2)
    s, sp = load_settings(t["settings"]), load_species(t["species"])
    ref_op = ref_data.load_optical_data(t["datadir"], sp.gas_names, [], s.op)
    ir = ref_data.load_channel(t["datadir"], "ir", None, ref_op)
    sol = ref_data.load_channel(t["datadir"], "solar", None, ref_op)
    op = optical_data_from_numpy(ref_op, ir, sol, "cpu", torch.float64)[0]
    rng = np.random.default_rng(3)
    zc = np.linspace(0.0, 7.0e6, nz)
    jitter = rng.uniform(0.95, 1.05, (3, 1))
    T = np.maximum(288.0 - 6.5e-5 * zc, 200.0) * jitter
    P = np.repeat((1.013 * np.exp(-zc / 8.0e5))[None], 3, 0)
    mix = np.full((nz, sp.ng), 1e-12)
    mix[:, sp.gas_names.index("H2O")] = 1e-2 * np.exp(-zc / 2e5) + 1e-6
    mix[:, sp.gas_names.index("CO2")] = 400e-6
    mix[:, sp.gas_names.index("N2")] = 0.78
    dens = mix[None] * (P * 1.0e6 / (1.380649e-16 * T))[..., None]
    dz = np.full((3, nz), 7.0e6 / nz)
    return ref_op, op, (P, T, dens, dz)


@pytest.mark.parametrize("stage", ["ktable", "mix"])
def test_split_stages_match_reference(tables, stage):
    """Each k-table's interpolation per column against the JAX package's
    (nz, G, W) form; the RORR mix of the chain's own (nk, G, W, B, nz)
    species tensor against the JAX sort path."""
    import jax.numpy as jnp
    from clima_tpu.ops.rorr import k_rorr_mix as ref_k_rorr_mix
    from clima_tpu.radtran import opacity as ref_om
    from clima_tpu_torch.radtran import opacity as om

    ref_op, op, (P, T, dens, dz) = tables
    # TOA-down, as compute_opacity hands them to its stages
    inputs = [torch.tensor(x) for x in (P, T, dens, dz)]
    _, Tt, _, _, _, _, log10P, cols = om._toa_down(*inputs, None, None)
    if stage == "ktable":
        for kt, ref_kt in zip(op.k, ref_op.k):
            got = om._interp_ktable(kt, log10P, Tt).numpy()  # (G, W, B, nz)
            for b in range(Tt.shape[0]):
                want = np.asarray(ref_om._interp_ktable(ref_kt, jnp.asarray(log10P[b].numpy()),
                                                        jnp.asarray(Tt[b].numpy())))
                np.testing.assert_allclose(got[:, :, b], np.moveaxis(want, 0, -1), rtol=1e-12)
    else:
        tau_ks = om._k_distributions(op, om._kweights(op, log10P, Tt), cols)
        got = om._mix(op, tau_ks).numpy()  # (G, W, B, nz)
        want = np.asarray(ref_k_rorr_mix(jnp.asarray(np.moveaxis(tau_ks.numpy(), 1, -1)),
                                         jnp.asarray(ref_op.kset.wbin_e)))  # (W, B, nz, G)
        np.testing.assert_allclose(got, np.moveaxis(want, -1, 0), rtol=1e-12)


def _no_card(monkeypatch, tool, argv):
    """Without a card and without --device cpu the tool raises."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(argv)


def test_profile_stages_on_the_cpu(monkeypatch, tmp_path):
    _no_card(monkeypatch, profile_stages, ["--columns", "2", "--nz", str(NZ)])
    out = tmp_path / "stages.json"
    res = profile_stages.main(SMALL + ["--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    names = [r["stage"] for r in res["stages"]]
    assert names == ["compute_opacity", "radiate_ir", "radiate_solar", "integrate_fluxes", "full"]
    for r in res["stages"]:
        assert np.isfinite(r["per_call_ms"]) and r["per_call_ms"] > 0 and r["host_ms"] > 0
        assert r["launches"] in (None, 0) and r["event_ms"] is None and r["busy_ms"] is None
    total = res["sum"]
    assert total["stage"] == "sum" and total["columns"] == 2 and total["card"] is None
    assert total["per_call_ms"] == sum(r["per_call_ms"] for r in res["stages"][:-1])
    assert np.isfinite([total["ISR_mean"], total["OLR_mean"]]).all()


def test_opacity_substages_on_the_cpu(monkeypatch, tables):
    """Every stage with the haze, rest closing the sum to the whole; the
    composed stages bitwise equal to compute_opacity in the tool and on the
    file's own template (its JAX tables)."""
    from clima_tpu_torch.radtran import compute_opacity

    _no_card(monkeypatch, opacity_substages, ["--columns", "2", "--nz", str(NZ)])
    res = opacity_substages.main(SMALL + ["--particles"])
    assert res["composed_bitwise"] and res["particles"]
    recs = {r["stage"]: r for r in res["stages"]}
    assert list(recs) == ["hat_weights", "ktable_f64", "ktable_f32", "rorr_kernel", "rorr_sort",
                          "rayleigh", "absorption", "particles", "combine", "whole", "rest"]
    chain = [r for r in res["stages"] if r["in_chain"]]
    assert {r["stage"] for r in chain} == set(opacity_substages.CHAIN) | {"rest"}
    assert sum(r["host_ms"] for r in chain) == pytest.approx(recs["whole"]["host_ms"])
    for name, r in recs.items():
        if name != "rest":
            assert np.isfinite(r["host_ms"]) and r["host_ms"] > 0, name
            assert r["launches"] in (None, 0), name
    assert recs["rorr_sort"]["max_rel_diff"] <= 1e-12  # the kernel's twin is the sort path
    assert recs["ktable_f32"]["max_rel_diff"] < 1e-3
    for name in ("ktable_f64", "rorr_kernel", "whole"):
        assert recs[name]["bound_ms"] > 0 and recs[name]["bound_by"] in ("bytes", "operations")

    _, op, cols = tables
    inputs = [torch.tensor(x) for x in cols]
    composed, stages = opacity_substages.run_stages(op, *inputs)
    whole = compute_opacity(op, *inputs)
    assert set(stages) == set(opacity_substages.CHAIN)
    assert all(torch.equal(composed[k], whole[k]) for k in whole)


def test_rorr_crossover_on_the_cpu(monkeypatch, tmp_path):
    argv = ["--nbins", "4", "8", "20", "--nw", "4", "--nz", "6", "--iters", "2"]
    _no_card(monkeypatch, rorr_crossover, argv)
    out = tmp_path / "crossover.json"
    res = rorr_crossover.main(argv + ["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert [r["nbin"] for r in res["rows"]] == [4, 8, 20]
    assert res["shape"] == dict(nk=3, nw=4, nz=6) and res["agree"]
    for r in res["rows"]:
        assert r["lanes"] == 24 and np.isfinite(r["sort_ms"]) and r["sort_ms"] > 0
        if r["nbin"] <= 16:
            assert r["max_rel_diff"] <= 1e-9 and r["agree"] and r["kernel_ms"] > 0
            assert r["speedup"] == r["sort_ms"] / r["kernel_ms"]
            assert "kernel_error" not in r
        else:
            assert "nbin <= 16" in r["kernel_error"] and "kernel_ms" not in r
    speedups = [r["speedup"] for r in res["rows"] if "speedup" in r]
    assert res["crossover_nbin"] == next(
        (r["nbin"] for r in res["rows"] if r.get("speedup", 1.0) < 1.0), None)
    assert len(speedups) == 2


@pytest.mark.cuda
def test_stage_tools_on_the_card(tmp_path):
    """The three tools small on the card: every stage finite and launching
    kernels, the composed stages bitwise, the kernel within 1e-9 of the sort
    path and the card's name in every record."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    argv = ["--columns", "4", "--nz", "42", "--iters", "2"]
    res = profile_stages.main(argv)
    for r in res["stages"]:
        assert r["event_ms"] > 0 and r["busy_ms"] > 0 and r["launches"] >= 1, r["stage"]
        assert r["idle_share"] < 1.0
    assert res["card"] and res["sum"]["launches"] >= 5
    sub = opacity_substages.main(argv)
    assert sub["composed_bitwise"] and sub["card"] == res["card"]
    recs = {r["stage"]: r for r in sub["stages"]}
    assert recs["rorr_kernel"]["launches"] >= 1 and recs["rorr_sort"]["max_rel_diff"] <= 1e-9
    assert all(np.isfinite(r["event_ms"]) for r in sub["stages"])
    cross = rorr_crossover.main(["--nbins", "8", "16", "20", "--nw", "4", "--nz", "42",
                                 "--out", str(tmp_path / "c.json")])
    assert cross["agree"] and [r["nbin"] for r in cross["rows"]] == [8, 16, 20]
    assert cross["rows"][2]["sort_peak_MiB"] > 0 and "kernel_error" in cross["rows"][2]
