"""Clima's EarlyMars forward column on the port (the benchmark's
``early_mars_adiabat`` configuration, ``portbench/configs/early_mars_adiabat.json``):
the port's ``column_model`` against the benchmark's plain reference
(``portbench/reference/adiabat.py``) with a column in each CO2 regime (saturated
at the surface, condensing from aloft, dry), the cell's traffic reaching all
three, the march's event counters and the configuration against the port's
example, on the CPU at small sizes. The tests marked ``cuda`` hold the march
kernel to its twin on Mars columns at nz 100 and its span to CUDA events (on a
card: ``python -m pytest --noconftest tests/test_torch_early_mars_cell.py -m
cuda``; skipped without one)."""

import copy
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from clima_tpu_torch.adiabat import AdiabatClimate, profile
from clima_tpu_torch.config import settings_from_dict
from clima_tpu_torch.examples import early_mars
from clima_tpu_torch.ops import march_cuda
from clima_tpu_torch.parallel.pipeline import make_column_fns
from clima_tpu_torch.utils import profiling
from portbench import traffic
from portbench.reference import adiabat as ref, optics, radtran as ref_rt, synthetic
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD = "early_mars_adiabat.co2_sweep.c1024"
CPU = torch.device("cpu")
# (T_surf K, CO2 dyn/cm^2): CO2 saturated at the surface, condensing from
# aloft, dry all the way up; a 270-bar ocean, every other gas 1e-15
REGIMES = ((202.0, 2.5e6), (220.0, 2.0e6), (260.0, 1.0e5))


def _json(*path):
    with open(os.path.join(ROOT, "portbench", *path)) as f:
        return json.load(f)


CONFIG = _json("configs", "early_mars_adiabat.json")
MIX = _json("traffic", "mars_co2_sweep.c1024.json")
GASES = CONFIG["gases"]


@pytest.fixture(autouse=True)
def _empty_rings():
    profiling.clear()
    yield
    profiling.clear()


def _model(nz, substeps, device):
    """The configuration's model at ``nz`` layers, as the benchmark's entry
    builds it, and the settings it was built from."""
    settings = copy.deepcopy(CONFIG["settings"])
    settings["atmosphere-grid"]["number-of-layers"] = nz
    tree = synthetic.synthetic_datadir(**CONFIG["spectral_data"])
    c = AdiabatClimate(synthetic.species_document(), settings_from_dict(settings, "mars"),
                       synthetic.star_table(), tree, substeps=substeps, device=device)
    return c, tree, settings


def _regime_columns(dtype=torch.float64, device=CPU):
    P_i = torch.full((len(REGIMES), len(GASES)), 1e-15, dtype=dtype, device=device)
    P_i[:, GASES.index("H2O")] = 270e6
    P_i[:, GASES.index("CO2")] = torch.tensor([p for _, p in REGIMES], dtype=dtype)
    return torch.tensor([t for t, _ in REGIMES], dtype=dtype, device=device), P_i


def _march(c, T_surf, P_i):
    """The surface split and the twin's march: (start, (T_e, z_e, f_i_e,
    P_trop, events))."""
    RH = torch.ones(len(GASES), dtype=T_surf.dtype, device=T_surf.device)
    s = profile._start(c._par, RH, T_surf, P_i, c.T_trop)
    return s, profile._march_torch(c._par, RH, T_surf, s)


def test_column_model_matches_the_reference_in_each_co2_regime():
    """The port's column model (the twin march on the CPU) against the plain
    reference at nz 6, two substeps, one column in each CO2 regime: every
    relative gap within the cell's limits; the saturated column's CO2 goes to
    the surface reservoir and caps the surface pressure."""
    c, tree, settings = _model(6, 2, CPU)
    T_surf, P_i = _regime_columns()
    s, (*_, events) = _march(c, T_surf, P_i)
    co2 = GASES.index("CO2")
    assert s.mask0[:, co2].tolist() == [True, False, False]
    assert events[:, 1].tolist() == [0, 1, 0]
    got = make_column_fns(c)["column_model"](T_surf, P_i, c.T_trop)

    planet = settings["planet"]
    chain = ref_rt.Chain(optics.load_tables(tree, GASES, [],
                                            settings["optical-properties"]["opacities"]),
                         synthetic.star_table(), planet["number-of-zenith-angles"],
                         planet["surface-albedo"], CPU, torch.float64,
                         photon_scale=planet["photon-scale-factor"])
    m = ref.Model.build(synthetic.species_document(), 6, planet["planet-mass"],
                        planet["planet-radius"], chain, CPU, torch.float64,
                        P_top=CONFIG["P_top_dyn_cm2"], T_trop=CONFIG["T_trop_K"], substeps=2)
    want = ref.column_model(m, T_surf, P_i)
    def rel(k):
        return float(torch.max(torch.abs(got[k] - want[k]) / torch.abs(want[k])))

    limits = _json("limits", WORKLOAD + ".json")
    gaps = dict(toa_flux_gap=max(rel("ISR"), rel("OLR")), surface_pressure_gap=rel("P_surf"),
                column_amount_gap=rel("N_atmos"))
    assert all(gaps[k] <= limits[k] for k in limits), (gaps, limits)
    reservoir = ref.make_profile(m, torch.ones(len(GASES), dtype=torch.float64), T_surf,
                                 P_i)["N_surface"]
    assert got["N_surface"][0, co2] > 0 and torch.all(got["N_surface"][1:, co2] == 0)
    torch.testing.assert_close(got["N_surface"], reservoir, rtol=1e-12, atol=0)
    assert got["P_surf"][0] < P_i[0].sum() and torch.equal(got["P_surf"][1:], want["P_surf"][1:])


def test_cell_traffic_reaches_every_co2_regime():
    """At two of the run's seeds the cell's traffic holds columns whose CO2
    is saturated at the surface (its whole 2048 columns classified), columns
    where CO2 starts to condense aloft and columns where it never does (the
    first 96 columns marched at nz 6)."""
    c, _, _ = _model(6, 2, CPU)
    co2 = GASES.index("CO2")
    for seed in (3_000_000_019, 2_718_281_828):
        batches = traffic.surface_sweep(MIX, GASES, seed, CPU, torch.float64)
        T_all = torch.cat([T for T, _ in batches])
        P_all = torch.cat([P for _, P in batches])
        assert T_all.shape == (2 * 1024,)
        RH = torch.ones(len(GASES), dtype=torch.float64)
        _, _, mask0, _ = profile.surface_classification(c._par, RH, T_all, P_all)
        assert 0 < int(mask0[:, co2].sum()) < 0.05 * len(T_all)
        s, (*_, events) = _march(c, T_all[:96], P_all[:96])
        onset = events[:, 1].bool() & ~s.mask0[:, co2]
        assert 0.15 < float(onset.float().mean()) < 0.6, float(onset.float().mean())
        assert (~onset & ~s.mask0[:, co2]).any()


def test_march_counts_events_only_while_recording():
    """The twin's event counters grow only inside profiling.recording(), by
    the sums of its per-column counts, and a column_model request records
    their growth."""
    c, _, _ = _model(6, 2, CPU)
    T_surf, P_i = _regime_columns()
    before = profiling._counters()
    _, (*_, events) = _march(c, T_surf, P_i)
    assert profiling._counters() == before and events[:, 0].sum() > 0
    with profiling.recording():
        _, (*_, again) = _march(c, T_surf, P_i)
    assert torch.equal(again, events)
    after = profiling._counters()
    assert after["event_splits"]["_march_torch"] - before["event_splits"]["_march_torch"] == \
        int(events[:, 0].sum())
    assert after["onset_columns"]["_march_torch"] - before["onset_columns"]["_march_torch"] == 1
    assert after["event_splits"]["moist_adiabat_march_cuda"] == \
        before["event_splits"]["moist_adiabat_march_cuda"]
    with profiling.recording():
        make_column_fns(c)["column_model"](T_surf, P_i, c.T_trop)
    req = profiling.records()["requests"][-1]
    assert req["counters"]["event_splits"] == {"_march_torch": int(events[:, 0].sum())}
    assert req["counters"]["onset_columns"] == {"_march_torch": 1}


def test_configuration_is_the_examples_mars():
    """The configuration's planet and grid settings are those of the port's
    example at the template's nz 100, and its gases the template's."""
    want = early_mars.mars_settings(100)
    got = settings_from_dict(CONFIG["settings"], "early_mars_adiabat")
    for key in ("planet_mass", "planet_radius", "surface_albedo", "number_of_zenith_angles",
                "photon_scale_factor", "nz"):
        assert getattr(got, key) == getattr(want, key), key
    assert CONFIG["reduced"] == [] and CONFIG["dtype"] == "float64"
    assert GASES == [s["name"] for s in synthetic.species_document()["species"]]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_march_kernel_matches_twin_on_mars_columns(dev):
    """make_profile_core on the card (the march kernel) against the graphed
    twin from the same start, on 256 of the cell's columns and the three
    regime columns at nz 100, six substeps: float64 at rtol 1e-12, and the
    same per-column events; a large share of the columns takes an onset."""
    c, _, _ = _model(100, 6, dev)
    T, P = traffic.surface_sweep(MIX, GASES, 3_000_000_019, dev, torch.float64)[0]
    T_r, P_r = _regime_columns(device=dev)
    T_surf, P_i = torch.cat([T[:256], T_r]), torch.cat([P[:256], P_r])
    RH = torch.ones(len(GASES), dtype=torch.float64, device=dev)
    s = profile._start(c._par, RH, T_surf, P_i, c.T_trop)
    got = march_cuda.moist_adiabat_march_cuda(c._par, RH, T_surf, s.T_trop, s.mask0, s.r_dry,
                                              s.P_e, s.f_i_surf)
    want = profile._march_torch(c._par, RH, T_surf, s)
    for k, g, w in zip(("T_e", "z_e", "P_trop"), (got[0], got[1], got[3]),
                       (want[0], want[1], want[3])):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-12, atol=0.0,
                                   err_msg=k)
    # Where CO2 and H2O both condense, f_dry = 1 - f_H2O - f_CO2 cancels: an
    # ulp of T moves the five trace gases' f_dry * r by up to ~1e-7 of
    # themselves (the reference alike), ~1e-15 in absolute terms. H2O and CO2
    # are held at rtol 1e-12 alone, the trace gases also within 1e-14 of 1.
    cond = [GASES.index("H2O"), GASES.index("CO2")]
    trace = [i for i in range(len(GASES)) if i not in cond]
    g, w = got[2].cpu().numpy(), want[2].cpu().numpy()
    np.testing.assert_allclose(g[..., cond], w[..., cond], rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(g[..., trace], w[..., trace], rtol=1e-12, atol=1e-14)
    assert torch.equal(got[4], want[4])
    assert got[4][-3:, 1].tolist() == [0, 1, 0]
    assert 0.2 < float(got[4][:256, 1].float().mean()) < 0.6


@pytest.mark.cuda
def test_march_kernel_span_matches_cuda_events(dev):
    """Under recording, the span adiabat.profile.march.kernel's markers time
    the launch within 5 % of CUDA events around the wrapper, on 1024 of the
    cell's columns at nz 100; the kernel's counters grow by its per-column
    events then, and not in an unrecorded call."""
    c, _, _ = _model(100, 6, dev)
    T_surf, P_i = traffic.surface_sweep(MIX, GASES, 3_000_000_019, dev, torch.float64)[0]
    wrapped, timed = march_cuda.moist_adiabat_march_cuda, []

    def bracketed(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = wrapped(*args)
        end.record()
        timed.append((start, end, out[4]))
        return out

    with mock.patch.object(profile, "moist_adiabat_march_cuda", bracketed):
        profile.make_profile_core(c._par, c._tensor(c.RH), T_surf, P_i, c.T_trop)  # warm
        torch.cuda.synchronize()
        before = profiling._counters()
        profile.make_profile_core(c._par, c._tensor(c.RH), T_surf, P_i, c.T_trop)
        torch.cuda.synchronize()
        for k in ("event_splits", "onset_columns"):
            assert profiling._counters()[k] == before[k], k
        with profiling.recording():
            profile.make_profile_core(c._par, c._tensor(c.RH), T_surf, P_i, c.T_trop)
    torch.cuda.synchronize()
    start, end, events = timed[-1]
    (kernel,) = [s for s in profiling.records()["spans"]
                 if s["name"] == "adiabat.profile.march.kernel"]
    span_ms = (kernel["device_end_ns"] - kernel["device_start_ns"]) / 1e6
    event_ms = start.elapsed_time(end)
    assert abs(span_ms - event_ms) <= 0.05 * event_ms, (span_ms, event_ms)
    after = profiling._counters()
    name = "moist_adiabat_march_cuda"
    assert after["event_splits"][name] - before["event_splits"][name] == int(events[:, 0].sum())
    assert after["onset_columns"][name] - before["onset_columns"][name] == int(events[:, 1].sum())
    print(f"march kernel at 1024 Mars columns: span {span_ms:.3f} ms, CUDA events "
          f"{event_ms:.3f} ms; splits {events[:, 0].float().mean():.3f} a column, onsets "
          f"{events[:, 1].float().mean():.3f} of the columns")
