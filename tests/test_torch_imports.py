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
    "chip_smoke",
]


def test_port_imports_without_jax():
    """Every module of the port imports with JAX made unimportable, and no JAX
    module and no module of clima_tpu is loaded afterwards."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = [m for m in sys.modules if m.startswith(('jax.', 'jaxlib', 'clima_tpu.'))\n"
        "          or m == 'clima_tpu']\n"
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
