"""Entry: the radiative-transfer chain of ``clima_tpu_torch`` on batches of
prescribed columns, as a user of the standalone ``Radtran`` runs it.

One call is one batch of columns through the chain that the port's column
model runs: ``compute_opacity`` (k-tables, the RORR kernel, continua,
particles), ``radiate_ir`` (the weighted IR kernel), ``radiate_solar`` (the
weighted multi-zenith solar kernel, without amean) and ``integrate_fluxes``
for both channels, closed by a device sync. The benchmark calls the chain's
functions itself, looked up in the port's modules at each call. The answer of
a column is its four integrated flux profiles at every level; the kept
answers are compared with the plain reference of :mod:`..reference.radtran`.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import traffic
from portbench.metrics import _trace
from portbench.reference import optics, radtran as ref, synthetic

SPANS = ("opacity", "radiate_ir", "radiate_solar", "integrate")
MAX_KEPT_CALLS = 8192
REFERENCE_BLOCK = 256  # columns per block of the reference
TRACED_SECONDS = 1.0  # the traced calls last about this long, 5 to 40 of them


class Cell:
    """One run of a cell: ``setup()``, then ``call(i)`` for each batch call
    of the window, then ``trace()`` and ``check(calls)``."""

    def __init__(self, config, mix, seed, device, dtype=None):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.dtype = dtype or getattr(torch, config["dtype"])
        self.span = lambda name: contextlib.nullcontext()

    def setup(self):
        from clima_tpu_torch.config import settings_from_dict
        from clima_tpu_torch.radtran import Radtran

        cfg, dev, dt = self.config, self.device, self.dtype
        t0 = time.perf_counter()
        self.tree = synthetic.synthetic_datadir(**cfg["spectral_data"])
        self.star = synthetic.star_table()
        planet = cfg["settings"]["planet"]
        self.n_zenith = planet["number-of-zenith-angles"]
        settings = settings_from_dict(cfg["settings"], cfg["name"])
        rad = Radtran(cfg["gases"], cfg["particles"], settings, self.star, self.n_zenith,
                      planet["surface-albedo"], cfg["radiative_layers"], self.tree, device=dev,
                      dtype=dt)
        t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dt, device=dev)
        self.op = rad.op
        self.ir_slice = (rad.ir.ind_start, rad.ir.ind_end)
        self.sol_slice = (rad.sol.ind_start, rad.sol.ind_end)
        self.surface = dict(emis=t(rad.surface_emissivity), alb=t(rad.surface_albedo),
                            photons=t(rad.photons_sol * rad.photon_scale_factor),
                            zen_u=t(rad.zenith_u), zen_w=t(rad.zenith_weights),
                            hard=rad.has_hard_surface, tau_min=rad.ir_tau_min,
                            diurnal=rad.diurnal_fac)
        nz = cfg["radiative_layers"]
        t1 = time.perf_counter()
        self.inputs64 = traffic.prescribed_columns(self.mix, cfg["gases"], len(cfg["particles"]),
                                                   nz, self.seed, dev, torch.float64)
        self.batches = [{k: v.to(dt) for k, v in b.items()} for b in self.inputs64]
        B, K = self.mix["columns_per_call"], self.mix["kept_columns_per_call"]
        self.kept_idx = torch.randint(0, B, (MAX_KEPT_CALLS, K), device=dev,
                                      generator=traffic.generator(self.seed, dev, 1))
        self.kept = torch.empty((MAX_KEPT_CALLS, 4, K, nz + 1), dtype=dt, device=dev)
        self._sync()
        t2 = time.perf_counter()
        for i in range(2):  # warm-up: the cell's one shape
            self.run(self.batches[i % len(self.batches)])
        self._sync()
        self.setup_phases = dict(model_s=t1 - t0, inputs_s=t2 - t1,
                                 warm_up_s=time.perf_counter() - t2)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, b):
        """The chain on one batch: (fup_ir, fdn_ir, fup_sol, fdn_sol), each
        (B, nz+1) ground-up."""
        from clima_tpu_torch.radtran import opacity, radiate

        op, sf = self.op, self.surface
        (i0, i1), (s0, s1) = self.ir_slice, self.sol_slice
        with self.span("opacity"):
            opr = opacity.compute_opacity(op, b["P"], b["T"], b["dens"], b["dz"], b.get("pdens"),
                                          b.get("radii"))
        with self.span("radiate_ir"):
            ir = radiate.radiate_ir(self.ir_slice, op.freq, op.kset.wbin, opr, sf["emis"],
                                    sf["hard"], sf["tau_min"], b["T_surf"], b["T"])
        with self.span("radiate_solar"):
            sol = radiate.radiate_solar(self.sol_slice, op.freq, op.wavl, op.kset.wbin, opr,
                                        sf["alb"], sf["diurnal"], sf["photons"], sf["zen_u"],
                                        sf["zen_w"], compute_amean=False)
        with self.span("integrate"):
            fup_ir, fdn_ir = radiate.integrate_fluxes(ir["fup_a"], ir["fdn_a"], op.freq[i0:i1 + 2])
            fup_sol, fdn_sol = radiate.integrate_fluxes(sol["fup_a"], sol["fdn_a"],
                                                        op.freq[s0:s1 + 2])
        return fup_ir, fdn_ir, fup_sol, fdn_sol

    def call(self, i):
        """Batch call ``i`` of the window, closed by a device sync; returns
        the columns it completed. Its kept answers are copied after the sync."""
        out = self.run(self.batches[i % len(self.batches)])
        self._sync()
        if i < MAX_KEPT_CALLS:
            self.kept[i] = torch.stack(out)[:, self.kept_idx[i]]
        return self.mix["columns_per_call"]

    def shapes(self):
        """The sizes the readers' operation and byte counts take."""
        op = self.op
        B, nz = self.mix["columns_per_call"], self.config["radiative_layers"]
        nG = op.kset.nbin
        nw_ir = self.ir_slice[1] - self.ir_slice[0] + 1
        nw_sol = self.sol_slice[1] - self.sol_slice[0] + 1
        return dict(columns=B, nz=nz, nw=op.nw, nbin=nG, ng=len(self.config["gases"]),
                    nk=len(op.k), rorr_lanes=B * op.nw * nz, ir_rows=B * nw_ir * nG,
                    solar_rows=B * nw_sol * nG, n_zenith=self.n_zenith)

    def trace(self, window_calls, window_s):
        """Per-layer readings of traced calls (after the window): the calls
        under ``torch.profiler`` with a ``record_function`` span around each
        stage."""
        from torch.profiler import ProfilerActivity, profile, record_function

        n = int(min(40, max(5, TRACED_SECONDS * window_calls / window_s)))
        self.span = lambda name: record_function(name)
        try:
            for _ in range(_trace.PASSES):
                self._sync()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for i in range(n):
                        self.run(self.batches[i % len(self.batches)])
                        self._sync()
                    t1 = time.perf_counter()
                r = _trace.read_profile(prof, SPANS)
                if r["ok"]:
                    break
        finally:
            self.span = lambda name: contextlib.nullcontext()
        if not r["ok"]:
            return dict(calls=n, window_s=t1 - t0, lost_records=True, shapes=self.shapes())
        return dict(calls=n, window_s=t1 - t0, call_s=(t1 - t0) / n, busy_s=r["busy_s"],
                    span_busy_s=r["span_busy_s"], kernels=r["kernels"],
                    launch_calls=r["launch_calls"], unattributed=r["unattributed"],
                    matched=r["matched"], unattributed_s=r["unattributed_s"],
                    gaps=r["gaps"], shapes=self.shapes(), lost_records=False)

    def release(self):
        """Free the program's state before the reference runs."""
        self.op = self.batches = self.surface = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, calls):
        """The kept answers of the window's calls against the plain
        reference in float64: the widest gap of each channel's flux profiles,
        as a share of the profile's largest reference value. Returns ({number:
        its value in each kept call (n,)}, the answers compared)."""
        cfg = self.config
        K, D = self.mix["kept_columns_per_call"], len(self.inputs64)
        n = min(calls, MAX_KEPT_CALLS)
        kept = self.kept[:n].to(torch.float64)
        idx = self.kept_idx[:n].cpu().numpy()
        planet = cfg["settings"]["planet"]
        tables = optics.load_tables(self.tree, cfg["gases"], cfg["particles"],
                                    cfg["settings"]["optical-properties"]["opacities"])
        chain = ref.Chain(tables, self.star, planet["number-of-zenith-angles"],
                          planet["surface-albedo"], self.device, torch.float64,
                          photon_scale=planet.get("photon-scale-factor", 1.0))
        gaps = torch.zeros((n, K, 2), dtype=torch.float64, device=self.device)
        for d in range(D):
            rows = [(j, k) for j in range(d, n, D) for k in range(K)]
            if not rows:  # fewer calls than batches
                continue
            cols = np.unique([idx[j, k] for j, k in rows])
            where = {c: i for i, c in enumerate(cols)}
            out = []
            for a in range(0, len(cols), REFERENCE_BLOCK):
                sel = torch.as_tensor(cols[a:a + REFERENCE_BLOCK], device=self.device)
                b = {key: v[sel] for key, v in self.inputs64[d].items()}
                out.append(torch.stack(ref.fluxes(chain, b["T_surf"], b["P"], b["T"], b["dens"],
                                                  b["dz"], b.get("pdens"), b.get("radii"))))
            out = torch.cat(out, dim=1)  # (4, unique columns, nz+1)
            js = torch.as_tensor([j for j, _ in rows], device=self.device)
            ks = torch.as_tensor([k for _, k in rows], device=self.device)
            r = out[:, torch.as_tensor([where[idx[j, k]] for j, k in rows], device=self.device)]
            p = kept[js, :, ks].transpose(0, 1)  # (4, answers, nz+1)
            gap = (p - r).abs().amax(-1) / r.abs().amax(-1)  # (4, answers)
            gaps[js, ks, 0] = torch.maximum(gap[0], gap[1])
            gaps[js, ks, 1] = torch.maximum(gap[2], gap[3])
        gaps = torch.nan_to_num(gaps, nan=float("inf")).amax(dim=1).cpu().numpy()
        return dict(ir_flux_gap=gaps[:, 0], solar_flux_gap=gaps[:, 1]), n * K
