"""The PyTorch port never imports JAX, nor anything of the JAX package."""

import os
import subprocess
import sys

import clima_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "clima_tpu_torch",
    "clima_tpu_torch.constants",
    "clima_tpu_torch.config",
    "clima_tpu_torch.physics.eqns",
    "clima_tpu_torch.data.synthetic",
    "clima_tpu_torch.ops.rebin",
    "clima_tpu_torch.ops.interp",
    "clima_tpu_torch.ops.tridiag",
    "clima_tpu_torch.ops.twostream",
    "clima_tpu_torch.ops.twostream_cuda",
    "clima_tpu_torch.ops.rorr",
    "clima_tpu_torch.ops.rorr_cuda",
    "clima_tpu_torch.ops.cuda_build",
    "clima_tpu_torch.radtran.data",
    "clima_tpu_torch.radtran.opacity",
    "clima_tpu_torch.radtran.radiate",
    "clima_tpu_torch.radtran.radtran",
    "clima_tpu_torch.utils.device",
    "clima_tpu_torch.ops.cuda_graph",
    "clima_tpu_torch.physics.saturation",
    "clima_tpu_torch.solvers.newton",
    "clima_tpu_torch.solvers.ptc",
    "clima_tpu_torch.adiabat",
    "clima_tpu_torch.adiabat.profile",
    "clima_tpu_torch.adiabat.altitude",
    "clima_tpu_torch.adiabat.profile_dry",
    "clima_tpu_torch.adiabat.adiabat",
    "clima_tpu_torch.adiabat.profile_rc",
    "clima_tpu_torch.adiabat.rce",
    "clima_tpu_torch.adiabat.rce_device",
    "clima_tpu_torch.parallel",
    "clima_tpu_torch.parallel.pipeline",
    "clima_tpu_torch.parallel.solvers",
    "clima_tpu_torch.physics.water",
    "clima_tpu_torch.utils.shared_library",
    "clima_tpu_torch.tools.compare_twostream_builds",
    "clima_tpu_torch.config.atmosphere_file",
    "clima_tpu_torch.climate",
    "clima_tpu_torch.climate.climate",
    "clima_tpu_torch.utils.checkpoint",
    "clima_tpu_torch.utils.profiling",
    "clima_tpu_torch.tools.distributed_worker",
    "clima_tpu_torch.tools.roofline",
    "clima_tpu_torch.tools.validation",
    "clima_tpu_torch.tools.rce_bench",
    "clima_tpu_torch.tools.scaling",
    "clima_tpu_torch.tools.profile_stages",
    "clima_tpu_torch.tools.opacity_substages",
    "clima_tpu_torch.tools.rorr_crossover",
    "clima_tpu_torch.examples",
    "clima_tpu_torch.examples.modern_earth_radtran",
    "clima_tpu_torch.examples.tutorial_adiabat_climate",
    "clima_tpu_torch.examples.early_mars",
    "clima_tpu_torch.examples.climate_evolve",
    "chip_smoke",
]


def test_port_imports_without_jax():
    """Every module of the port imports with JAX made unimportable, and no JAX
    module, no module of clima_tpu and nothing of the JAX package's
    examples/, scripts/ or entry point is loaded afterwards."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = [m for m in sys.modules if m.startswith(('jax.', 'jaxlib', 'clima_tpu.'))\n"
        "          or m.split('.')[0] in ('clima_tpu', 'examples', 'scripts', '__graft_entry__',\n"
        "                                 'bench', 'bench_pipeline')]\n"
        "assert sys.modules['jax'] is None and not loaded, loaded\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_rce_surface_matches_reference():
    """The package exports the three RCE solve strategies with the JAX
    package's values, and AdiabatClimate has the RCE methods it attaches."""
    import clima_tpu_torch
    from clima_tpu_torch.adiabat import AdiabatClimate

    for name in ("RCE_SOLVE_HYBRJ_ONLY", "RCE_SOLVE_PTC_THEN_HYBRJ",
                 "RCE_SOLVE_HYBRJ_THEN_PTC_THEN_HYBRJ"):
        assert name in clima_tpu_torch.__all__
        assert getattr(clima_tpu_torch, name) == getattr(clima_tpu, name)
    for name in ("make_profile_rc", "RCE", "_set_convecting_zones", "_update_convecting_zones"):
        assert callable(getattr(AdiabatClimate, name))


def test_solver_and_rebin_exports_match_reference():
    """clima_tpu_torch.parallel exports the JAX package's batched solvers and
    clima_tpu_torch exports rebin_with_errors, as clima_tpu does."""
    import clima_tpu.parallel
    import clima_tpu_torch
    import clima_tpu_torch.parallel

    for name in ("newton_solve", "batched_make_column", "batched_make_profile_bg_gas",
                 "batched_surface_temperature_trop", "batched_surface_temperature_column",
                 "batched_surface_temperature_bg_gas"):
        assert name in clima_tpu.parallel.__all__ and name in clima_tpu_torch.parallel.__all__
        assert callable(getattr(clima_tpu_torch.parallel, name))
    assert "rebin_with_errors" in clima_tpu.__all__ and "rebin_with_errors" in clima_tpu_torch.__all__
    assert callable(clima_tpu_torch.rebin_with_errors)


def test_rce_device_signatures_match_reference():
    """clima_tpu_torch.adiabat.rce_device has the JAX package's public names,
    with the same parameters and defaults."""
    import inspect

    import clima_tpu.adiabat.rce_device as ref
    import clima_tpu_torch.adiabat.rce_device as port

    assert port.__all__ == ref.__all__ == ["build_rce_fns", "batched_rce"]
    for name in port.__all__:
        got = inspect.signature(getattr(port, name)).parameters
        want = inspect.signature(getattr(ref, name)).parameters
        assert [(p.name, p.default, p.kind) for p in got.values()] == \
            [(p.name, p.default, p.kind) for p in want.values()], name


def test_pipeline_signatures_match_reference():
    """The eight batched entry points and the mesh helpers take the JAX
    package's parameters with its defaults, mesh included;
    initialize_distributed adds one keyword, the process group's backend."""
    import clima_tpu.adiabat.rce_device as ref_rce_device
    import clima_tpu.parallel as ref

    import clima_tpu_torch.adiabat.rce_device as rce_device
    import clima_tpu_torch.parallel as port

    names = ("batched_toa_fluxes", "batched_surface_temperature", "batched_make_column",
             "batched_make_profile_bg_gas", "batched_surface_temperature_trop",
             "batched_surface_temperature_column", "batched_surface_temperature_bg_gas",
             "make_mesh", "shard_columns")
    pairs = [(getattr(port, n), getattr(ref, n)) for n in names]
    for got, want in pairs + [(rce_device.batched_rce, ref_rce_device.batched_rce)]:
        assert _params(got) == _params(want), got.__name__
        assert "mesh" in [p[0] for p in _params(got)] or got.__name__ in ("make_mesh",
                                                                            "shard_columns")
    got, want = _params(port.initialize_distributed), _params(ref.initialize_distributed)
    assert got[:len(want)] == want
    assert [(n, d) for n, d, _ in got[len(want):]] == [("backend", None)]


# modules of the JAX package that the port leaves out by design (ROADMAP
# North star): the df64 flux path, the native build of its own C library,
# and the Pallas kernels, which the CUDA kernels of ops/*_cuda.py replace
BY_DESIGN = (".ops.df64", ".ops.twostream_df", ".radtran.radiate_df", ".native",
             ".ops.pallas_")


def _modules(pkg):
    import pkgutil

    mods = {m.name[len(pkg.__name__):]: m.name
            for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    mods[""] = pkg.__name__
    return mods


def test_every_all_matches_reference():
    """Every module of the JAX package, but the by-design exclusions, has a
    module of the port whose __all__ holds every name of the JAX module's,
    each defined."""
    import importlib

    import clima_tpu_torch

    ref_mods, port_mods = _modules(clima_tpu), _modules(clima_tpu_torch)
    checked = 0
    for key, name in sorted(ref_mods.items()):
        if key.startswith(BY_DESIGN):
            continue
        assert key in port_mods, f"clima_tpu{key} has no port module"
        want = getattr(importlib.import_module(name), "__all__", None)
        if want is None:
            continue
        port = importlib.import_module(port_mods[key])
        missing = set(want) - set(getattr(port, "__all__", ()))
        assert not missing, f"{port.__name__}.__all__ lacks {sorted(missing)}"
        for n in want:
            assert getattr(port, n, None) is not None, f"{port.__name__}.{n}"
        checked += 1
    assert checked >= 30  # 38 of the JAX package's modules have an __all__


def _params(fn):
    import inspect

    return [(p.name, p.default, p.kind) for p in inspect.signature(fn).parameters.values()]


def test_climate_and_utils_signatures_match_reference():
    """Climate, the atmosphere file, the checkpoint and the profiling
    functions take the JAX package's parameters with its defaults; Climate's
    constructor adds only the port's device and dtype."""
    import torch

    import clima_tpu.climate as ref_climate
    import clima_tpu.config.atmosphere_file as ref_atm
    import clima_tpu.utils.checkpoint as ref_checkpoint
    import clima_tpu.utils.profiling as ref_profiling

    import clima_tpu_torch.climate as climate
    import clima_tpu_torch.config.atmosphere_file as atm
    import clima_tpu_torch.utils.checkpoint as checkpoint
    import clima_tpu_torch.utils.profiling as profiling

    assert climate.__all__ == ref_climate.__all__ == ["Climate", "load_evolve_file"]
    got, want = _params(climate.Climate.__init__), _params(ref_climate.Climate.__init__)
    assert got[:len(want)] == want
    assert [(n, d) for n, d, _ in got[len(want):]] == [("device", None), ("dtype", torch.float64)]
    for name in ("evolve", "right_hand_side", "_build_device_fns"):
        assert _params(getattr(climate.Climate, name)) == \
            _params(getattr(ref_climate.Climate, name)), name
    assert _params(climate.load_evolve_file) == _params(ref_climate.load_evolve_file)
    for port, ref in ((atm, ref_atm), (checkpoint, ref_checkpoint), (profiling, ref_profiling)):
        assert port.__all__ == ref.__all__
        for name in port.__all__:
            got, want = getattr(port, name), getattr(ref, name)
            if isinstance(want, type):
                got, want = got.__init__, want.__init__
            assert _params(got) == _params(want), f"{port.__name__}.{name}"


def test_config_exports_match_reference():
    """clima_tpu_torch.config exports every name clima_tpu.config does
    (heat_capacity and the atmosphere file among them)."""
    import clima_tpu.config as ref
    import clima_tpu_torch.config as port

    assert set(ref.__all__) <= set(port.__all__)
    for name in ref.__all__:
        assert getattr(port, name) is not None, name
    assert callable(port.heat_capacity) and callable(port.unpack_atmospherefile)
