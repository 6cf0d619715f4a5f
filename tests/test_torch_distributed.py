"""The port's batched entry points sharded over a ``columns`` mesh (CPU, gloo).

Two ranks of ``clima_tpu_torch.tools.distributed_worker`` join a gloo
process group over localhost and run, with ``mesh=make_mesh()``,
``batched_toa_fluxes``, ``batched_surface_temperature``,
``batched_make_column`` and ``batched_rce`` (capped as
``__graft_entry__.dryrun_multichip`` caps it, in up to two passes whose
continue/stop decisions are global) on ``test_torch_pipeline.py``'s model
(nz=6, 2 zenith angles, substeps=2) over B=4 columns, 2 per rank. Both ranks
must hold the same gathered results, and these must match the same calls
unsharded in this process: TOA fluxes at rtol 1e-12, the solves' flags,
statuses, masks and iteration counts equal and their values at rtol 1e-7.
Not bitwise: on the CPU a lane's last bits follow its position in the batch
(PyTorch's vectorised pow rounds its SIMD body and its scalar tail
differently), and a solve carries such an ulp through its FD Jacobian.

The gathered results are also held to the JAX package's
``batched_toa_fluxes``, ``batched_surface_temperature`` and
``batched_make_column`` on the same model and inputs, at
``test_torch_pipeline.py``'s and ``test_torch_solvers.py``'s limits, with the
iteration count (the largest over the ranks here, the global
``while_loop``'s there) and the flags equal. On the JAX side the column
model is evaluated column by column by its jitted self through
``jax.pure_callback`` (one compile instead of one per solve, as in
``test_torch_solvers.py``); the solves themselves are the JAX package's
code. The capped ``batched_rce`` is held only to the port: the JAX
package's traces for ~400 s (``test_torch_rce_device.py`` compares the
unsharded one under ``-m slow``).

A one-rank gloo group, and ``make_mesh()`` without a process group in this
process, must give the unsharded results bitwise (every process on one CPU
thread, the unsharded calls in a process of their own). ``test_torch_mesh.py`` tests the mesh helpers and the entry
points' checks without a model.
"""

import concurrent.futures
import contextlib
import multiprocessing
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from clima_tpu_torch.adiabat.rce_device import batched_rce
from clima_tpu_torch.parallel import (batched_make_column, batched_surface_temperature,
                                      batched_toa_fluxes, make_column_fns, make_mesh)
from clima_tpu_torch.tools import distributed_worker as worker

B = 4
MODEL = dict(nz=6, n_zenith=2, substeps=2, device="cpu")
# dryrun_multichip's caps, max_total_iters=3 a pass (chunk_iters), two passes
CAPS = {"max_newton_iters": 2, "max_ptc_steps": 2, "chunk_iters": 3, "max_chunks": 2}
TS = {"T_guess": 260.0, "max_iter": 8}
FLAGS = ("ts.2", "ts.3", "column.converged", "column.status", "rce.converged", "rce.status",
         "rce.convecting_with_below", "rce.rc_iters", "rce.solve_iters")
VALUES = ("ts.0", "column.P_i_surf", "rce.T_surf", "rce.T", "rce.P", "rce.z")


def _free_port():
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _one_thread():
    """Calls in this process on one CPU thread, as the ranks' (the same
    count for every result compared bitwise)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _inputs(c):
    """__graft_entry__._p_batch's columns, their column inventories scaled by
    1, 1.05, 0.95 and 1.1 as make_column's targets, and a seed ramp."""
    P_i = np.full((B, c.sp.ng), 1.0e-15)
    P_i[:, c.species_names.index("H2O")] = 270.0e6
    P_i[:, c.species_names.index("CO2")] = np.linspace(200.0, 800.0, B)
    P_i[:, c.species_names.index("N2")] = 1.0e6
    T_surf = np.linspace(270.0, 300.0, B)
    m = make_column_fns(c)["profile_only"](torch.tensor(T_surf), torch.tensor(P_i),
                                           float(c.T_trop))
    N_i = (m["N_atmos"] + m["N_surface"]).numpy() * np.array([1.0, 1.05, 0.95, 1.1])[:, None]
    return dict(T_surf=T_surf, P_i=P_i, N_i=N_i,
                T_seed=np.tile(np.linspace(280.0, 210.0, c.nz), (B, 1)))


def _calls(a):
    return [("toa", MODEL, batched_toa_fluxes, (a["T_surf"], a["P_i"]), {}),
            ("ts", MODEL, batched_surface_temperature, (a["P_i"],), TS),
            ("column", MODEL, batched_make_column, (a["T_surf"], a["N_i"]), {}),
            ("rce", MODEL, batched_rce, (a["P_i"], a["T_surf"], a["T_seed"]), CAPS)]


def _flat(prefix, out, into):
    if isinstance(out, (dict, tuple)):
        for k, v in (out.items() if isinstance(out, dict) else enumerate(out)):
            _flat(f"{prefix}.{k}", v, into)
    else:
        into[prefix] = out
    return into


def _results(results):
    """run_calls' outputs, flat: ``name.i`` for a tuple, ``name.key`` for a
    dict, nested keys joined by dots."""
    flat = {}
    for name, (out, _, _) in results.items():
        _flat(name, out, flat)
    return flat


def _jax_reference(arrays, tmp):
    """The JAX package's batched_toa_fluxes, batched_surface_temperature and
    batched_make_column (mesh=None) on the same model, its column model
    evaluated per column through jax.pure_callback (see the module
    docstring)."""
    import jax
    import jax.numpy as jnp

    from clima_tpu.adiabat import AdiabatClimate as RefAdiabatClimate
    from clima_tpu.data import make_template_dir
    from clima_tpu.parallel import pipeline as ref_pipeline
    from clima_tpu.parallel import solvers as ref_solvers

    t = make_template_dir(str(tmp), nz=MODEL["nz"], n_zenith=MODEL["n_zenith"])
    ref = RefAdiabatClimate(t["species"], t["settings"], t["star"], t["datadir"],
                            substeps=MODEL["substeps"])
    ref.verbose = False
    make_column_fns_ref = ref_pipeline.make_column_fns
    ng, T_trop = ref.sp.ng, float(ref.T_trop)
    column = jax.jit(make_column_fns_ref(ref)["column_model"])
    spec = jax.eval_shape(column, 280.0, jnp.ones(ng), 180.0)

    def host(T_surf, P_i, T_trop):
        lead = np.shape(T_surf)
        T_surf, T_trop = (np.broadcast_to(x, lead).ravel() for x in (T_surf, T_trop))
        P_i = np.broadcast_to(P_i, lead + (ng,)).reshape(-1, ng)
        rows = [column(T_surf[i], P_i[i], T_trop[i]) for i in range(T_surf.size)]
        return {k: np.stack([np.asarray(r[k]) for r in rows]).reshape(lead + s.shape)
                for k, s in spec.items()}

    def column_model(T_surf, P_i, T_trop):
        return jax.pure_callback(host, spec, T_surf, P_i, T_trop, vmap_method="broadcast_all")

    def toa_fluxes(T_surf, P_i):
        m = column_model(T_surf, P_i, T_trop)
        return m["ISR"], m["OLR"]

    def routed(c):
        fns = make_column_fns_ref(c)
        step = fns["newton_step"]
        step.__closure__[step.__code__.co_freevars.index("toa_fluxes")].cell_contents = toa_fluxes
        profile = lambda *a: {k: v for k, v in column_model(*a).items()
                              if k in ("P_surf", "N_atmos", "N_surface", "f_i_surf")}
        return dict(fns, toa_fluxes=toa_fluxes, column_model=column_model,
                    profile_only=profile)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_pipeline, "make_column_fns", routed)
        mp.setattr(ref_solvers, "make_column_fns", routed)
        toa = ref_pipeline.batched_toa_fluxes(ref, arrays["T_surf"], arrays["P_i"])
        ts = ref_pipeline.batched_surface_temperature(ref, arrays["P_i"], **TS)
        col = ref_solvers.batched_make_column(ref, arrays["T_surf"], arrays["N_i"])
    out = {f"toa.{i}": v for i, v in enumerate(toa)}
    out.update({f"ts.{i}": v for i, v in enumerate(ts)})
    out.update({f"column.{k}": col[k] for k in ("P_i_surf", "converged", "status")})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(calls, the results of the two ranks and of the one-rank group, the
    unsharded results, the JAX package's). The ranks and the unsharded
    calls run in processes of their own while this one runs the JAX
    package's."""
    arrays = _inputs(worker.build_model(**MODEL))
    calls = _calls(arrays)
    dirs = [tmp_path_factory.mktemp(name) for name in ("two", "one", "tpl")]
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=torch.set_num_threads, initargs=(1,)) as pool:
        unsharded = pool.submit(worker.run_calls, calls, None)
        ctxs = [worker.start(world, calls, str(d), backend="gloo",
                             coordinator=f"127.0.0.1:{_free_port()}", threads=1)
                for world, d in ((2, dirs[0]), (1, dirs[1]))]
        try:
            jax_want = _jax_reference(arrays, dirs[2])
        finally:
            ranks = [worker.join(ctx, str(d), timeout=600) for ctx, d in zip(ctxs, dirs)]
        want = unsharded.result(timeout=600)
    return calls, ranks[0] + ranks[1], want, jax_want


def test_ranks_hold_the_same_whole_batch(run):
    _, (r0, r1, _), want, _ = run
    got0, got1, want = _results(r0), _results(r1), _results(want)
    assert set(got0) == set(got1) == set(want)
    for k in got0:
        np.testing.assert_array_equal(got0[k], got1[k], err_msg=k)
        assert got0[k].shape == want[k].shape, k
        assert got0[k].shape[:1] in ((B,), ()), k
    for name, (_, _, launches) in r0.items():
        assert set(launches) == {"two_stream_ir_weighted", "two_stream_solar_multi_weighted",
                                 "k_rorr_mix"} and not any(launches.values()), name


def test_sharded_toa_fluxes_match_unsharded(run):
    _, (r0, _, _), want, _ = run
    got, want = _results(r0), _results(want)
    for k in ("toa.0", "toa.1"):
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0.0, err_msg=k)


def test_sharded_solves_match_unsharded(run):
    """Flags, statuses, masks and iteration counts (the surface-temperature
    loop's global count among them) equal; values at rtol 1e-7."""
    _, (r0, _, _), want, _ = run
    got, want = _results(r0), _results(want)
    for k in FLAGS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in VALUES:
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=0.0, err_msg=k)
    assert got["ts.2"].all() and got["column.converged"].all()


def test_sharded_results_match_the_jax_package(run):
    """Rank 0's gathered TOA fluxes (rtol 1e-9), surface temperatures (rtol
    1e-8, residuals 1e-6) and make_column pressures (rtol 1e-8) against the
    JAX package's unsharded calls; the global iteration count, the
    convergence flags and statuses equal."""
    _, (r0, _, _), _, want = run
    got = _results(r0)
    for k in ("toa.0", "toa.1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    assert int(got["ts.3"]) == int(want["ts.3"])
    for k in ("ts.2", "column.converged", "column.status"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["ts.0"], want["ts.0"], rtol=1e-8)
    np.testing.assert_allclose(got["ts.1"], want["ts.1"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["column.P_i_surf"], want["column.P_i_surf"], rtol=1e-8)


def test_one_rank_group_is_bitwise(run):
    """Every call on a one-rank gloo group equals mesh=None bitwise."""
    _, (_, _, one), want, _ = run
    got, want = _results(one), _results(want)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_one_rank_mesh_is_bitwise(run):
    """make_mesh() without a process group: a one-rank mesh that starts none,
    on which the TOA fluxes equal mesh=None bitwise."""
    calls, _, want, _ = run
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("columns",)
    assert not dist.is_initialized()
    with _one_thread():
        got = _results(worker.run_calls(calls[:1], mesh))
    assert set(got) == {"toa.0", "toa.1"}
    for k, v in got.items():
        np.testing.assert_array_equal(v, _results(want)[k], err_msg=k)
    with pytest.raises(ValueError, match="n_devices=2"):
        make_mesh(n_devices=2)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(devices=[1])
    assert make_mesh(n_devices=1, devices=[0]).size() == 1
