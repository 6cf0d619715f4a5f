"""Entry: the forward column of ``clima_tpu_torch``'s ``AdiabatClimate`` on
batches of surface states, as a user sweeping surface temperature and CO2
runs it.

One call is ``make_column_fns(c)["column_model"]`` on one batch of columns:
the moist pseudoadiabat march (CUDA-graph replays of one grid interval,
captured anew in every call), the altitude solve (likewise), the doubled
radiative grid, ``compute_opacity``, both two-stream channels and the TOA
fluxes, closed by a device sync. The answer of a column is its ISR, OLR,
surface pressure and column amounts; a sample of the window's answers drawn
from the seed is compared with the plain reference of
:mod:`..reference.adiabat` (its march on the CPU).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import traffic
from portbench.metrics import _trace
from portbench.reference import adiabat as ref, optics, radtran as ref_rt, synthetic

class Cell:
    """One run of a cell: ``setup()``, then ``call(i)`` for each batch call
    of the window, then ``trace()`` and ``check(calls)``."""

    def __init__(self, config, mix, seed, device, dtype=None):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.dtype = dtype or getattr(torch, config["dtype"])

    def setup(self):
        from clima_tpu_torch.adiabat import AdiabatClimate
        from clima_tpu_torch.config import settings_from_dict
        from clima_tpu_torch.parallel.pipeline import make_column_fns

        cfg, dev = self.config, self.device
        t0 = time.perf_counter()
        self.tree = synthetic.synthetic_datadir(**cfg["spectral_data"])
        self.star = synthetic.star_table()
        self.species = synthetic.species_document()
        c = AdiabatClimate(self.species, settings_from_dict(cfg["settings"], cfg["name"]),
                           self.star, self.tree,
                           substeps=cfg["substeps"], device=dev, dtype=self.dtype)
        if (c.P_top, c.T_trop) != (cfg["P_top_dyn_cm2"], cfg["T_trop_K"]):
            raise ValueError("the model's P_top and T_trop differ from the configuration's")
        if c.species_names != cfg["gases"]:
            raise ValueError("the model's gases differ from the configuration's")
        self.model, self.gases = c, cfg["gases"]
        self.column_model = make_column_fns(c)["column_model"]
        t1 = time.perf_counter()
        self.inputs64 = traffic.surface_sweep(self.mix, self.gases, self.seed, dev, torch.float64)
        self.batches = [(T.to(self.dtype), P.to(self.dtype)) for T, P in self.inputs64]
        self.outputs = []
        self._sync()
        t2 = time.perf_counter()
        self.run(self.batches[0])  # warm-up: the cell's one shape
        self._sync()
        self.setup_phases = dict(model_s=t1 - t0, inputs_s=t2 - t1,
                                 warm_up_s=time.perf_counter() - t2)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, batch):
        T_surf, P_i = batch
        out = self.column_model(T_surf, P_i, self.model.T_trop)
        return [out[k] for k in ("ISR", "OLR", "P_surf", "N_atmos")]

    def call(self, i):
        """Batch call ``i`` of the window, closed by a device sync; returns
        the columns it completed. Its answers are kept."""
        self.outputs.append(self.run(self.batches[i % len(self.batches)]))
        self._sync()
        return self.mix["columns_per_call"]

    def trace(self, window_calls, window_s):
        """Per-layer readings of one traced call (after the window).

        The names the pipeline looks up are wrapped with synced host timers:
        ``make_profile_core`` (the march, its capture included),
        ``compute_altitude_core`` and the four radiative-transfer stages. The
        graph replays of the march and the altitude solve are bracketed with
        CUDA events (one replay runs some 28000 kernels, which the profiler is
        not asked to record), and ``torch.profiler`` records only the
        radiative-transfer stages. The device counts as busy through each
        replay and in the profiler's kernel intervals; the captures' warm-up
        runs count as idle.
        """
        import clima_tpu_torch.adiabat.altitude as alt_mod
        import clima_tpu_torch.adiabat.profile as prof_mod
        import clima_tpu_torch.parallel.pipeline as pipe
        from clima_tpu_torch.ops import cuda_graph
        from torch.profiler import ProfilerActivity, profile

        host = {"profile": 0.0, "altitude": 0.0, "radtran": 0.0}
        events = {"profile": [], "altitude": []}
        state = {"prof": None, "profiler_s": 0.0, "integrations": 0, "result": None}

        def timed(name, fn):
            def wrapper(*a, **k):
                self._sync()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self._sync()
                host[name] += time.perf_counter() - t0
                return out
            return wrapper

        def replays(name, graphed):
            def wrapper(fn, *inputs):
                replay, first = graphed(fn, *inputs)

                def bracketed(*args):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    out = replay(*args)
                    end.record()
                    events[name].append((start, end))
                    return out
                return bracketed, first
            return wrapper

        def radtran_stage(fn, first=False, last=False):
            def wrapper(*a, **k):
                if first:
                    self._sync()
                    t0 = time.perf_counter()
                    state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                        ProfilerActivity.CUDA])
                    state["prof"].__enter__()
                    state["t0"] = time.perf_counter()
                    state["profiler_s"] += state["t0"] - t0
                out = fn(*a, **k)
                if last:
                    state["integrations"] += 1
                    if state["integrations"] == 2:
                        self._sync()
                        t1 = time.perf_counter()
                        host["radtran"] += t1 - state["t0"]
                        state["prof"].__exit__(None, None, None)
                        state["profiler_s"] += time.perf_counter() - t1
                        state["result"] = _trace.read_profile(state["prof"], ())
                return out
            return wrapper

        names = {"make_profile_core": timed("profile", pipe.make_profile_core),
                 "compute_altitude_core": timed("altitude", pipe.compute_altitude_core),
                 "compute_opacity": radtran_stage(pipe.compute_opacity, first=True),
                 "radiate_ir": pipe.radiate_ir, "radiate_solar": pipe.radiate_solar,
                 "integrate_fluxes": radtran_stage(pipe.integrate_fluxes, last=True)}
        graphs = {prof_mod: replays("profile", prof_mod.graphed),
                  alt_mod: replays("altitude", alt_mod.graphed)}
        saved = {k: getattr(pipe, k) for k in names}
        saved_graphs = {m: m.graphed for m in graphs}
        capture0 = sum(cuda_graph.CAPTURE_SECONDS.values())
        try:
            for k, v in names.items():
                setattr(pipe, k, v)
            for m, v in graphs.items():
                m.graphed = v
            self._sync()
            t0 = time.perf_counter()
            self.run(self.batches[0])
            self._sync()
            window = time.perf_counter() - t0 - state["profiler_s"]
        finally:
            for k, v in saved.items():
                setattr(pipe, k, v)
            for m, v in saved_graphs.items():
                m.graphed = v
        capture = sum(cuda_graph.CAPTURE_SECONDS.values()) - capture0
        replay_s = {k: sum(s.elapsed_time(e) for s, e in v) / 1e3 for k, v in events.items()}
        r = state["result"]
        spans = dict(calls=1, window_s=window, span_host_s=dict(host),
                     counters=dict(capture_s=capture))
        if r is None or not r["ok"]:  # the device's busy time is not measured
            return dict(spans, lost_records=True)
        busy = r["busy_s"] + sum(replay_s.values())
        top = sorted(r["kernels"].items(), key=lambda kv: -kv[1][0])[:8]
        device_ops = [["march: interval graph replays", replay_s["profile"]],
                      ["altitude: interval graph replays", replay_s["altitude"]]]
        device_ops += [[_trace.short_name(name), s] for name, (s, _) in top]
        idle = [["march: host between replays (captures included)",
                 host["profile"] - replay_s["profile"]],
                ["altitude: host between replays (capture included)",
                 host["altitude"] - replay_s["altitude"]],
                ["radiative transfer: launch gaps", host["radtran"] - r["busy_s"]],
                ["column model: the rest", window - sum(host.values())]]
        return dict(spans, busy_s=busy, lost_records=False,
                    breakdown=dict(device_ops=device_ops,
                                   idle_gaps=sorted(idle, key=lambda kv: -kv[1])))

    def release(self):
        """Free the program's state before the reference runs."""
        self.model = self.column_model = self.batches = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, calls):
        """A sample of the window's answers, drawn from the seed, against the
        plain reference in float64 (the march and the altitude solve on the
        CPU, the radiative transfer on the run's device): the relative gaps of ISR and
        OLR, of the surface pressure and of each gas's column amount.
        Returns ({number: its value in each call (calls,), worst over the
        call's sampled answers}, the answers compared)."""
        cfg, B = self.config, self.mix["columns_per_call"]
        D, S = len(self.inputs64), self.mix["checked_columns"]
        rng = np.random.default_rng([self.seed % (1 << 63), 2])
        picks = rng.choice(calls * B, size=min(S, calls * B), replace=False)
        cpu = torch.device("cpu")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            s, planet = cfg["settings"], cfg["settings"]["planet"]
            tables = optics.load_tables(self.tree, cfg["gases"], [],
                                        s["optical-properties"]["opacities"])
            chain = ref_rt.Chain(tables, self.star, planet["number-of-zenith-angles"],
                                 planet["surface-albedo"], self.device, torch.float64,
                                 photon_scale=planet.get("photon-scale-factor", 1.0))
            m = ref.Model.build(self.species, s["atmosphere-grid"]["number-of-layers"],
                                planet["planet-mass"], planet["planet-radius"], chain, cpu,
                                torch.float64,
                                P_top=cfg["P_top_dyn_cm2"], T_trop=cfg["T_trop_K"],
                                substeps=cfg["substeps"])
            cols = [(int(p) // B, int(p) % B) for p in picks]
            T = torch.stack([self.inputs64[j % D][0][k] for j, k in cols]).cpu()
            P = torch.stack([self.inputs64[j % D][1][k] for j, k in cols]).cpu()
            r = ref.column_model(m, T, P)
        finally:
            torch.set_num_threads(threads)
        per_call = {k: np.zeros(calls) for k in ("toa_flux_gap", "surface_pressure_gap",
                                                  "column_amount_gap")}
        rel = lambda p, q: float(np.nan_to_num(np.max(np.abs(p - q) / np.abs(q)), nan=np.inf))
        for a, (j, k) in enumerate(cols):
            isr, olr, ps, na = (x[k].double().cpu().numpy() for x in self.outputs[j])
            gaps = dict(toa_flux_gap=max(rel(isr, r["ISR"][a].numpy()),
                                         rel(olr, r["OLR"][a].numpy())),
                        surface_pressure_gap=rel(ps, r["P_surf"][a].numpy()),
                        column_amount_gap=rel(na, r["N_atmos"][a].numpy()))
            for key, v in gaps.items():
                per_call[key][j] = max(per_call[key][j], v)
        return per_call, len(cols)
