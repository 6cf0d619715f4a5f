"""The snapshot streams of the PyTorch port's time-stepping Climate model
against clima_tpu's (float64, CPU), on test_torch_climate.py's template
(nz=10, 2 zenith angles, the atmosphere column and settings of
tests/test_climate.py): the DOP853 stream against the JAX package's (T and
the fluxes at rtol 1e-8 of each array's largest value, the grid and times at
1e-12), both packages' files read by either package, rk45_device against
DOP853 (rtol 1e-4, atol 1e-3) and against the JAX package's rk45_device (the
same steps; T at rtol 1e-8), and a NaN stage rejected and the integration
carried on.
"""

import os

import numpy as np
import pytest
import torch

from clima_tpu.climate import Climate as RefClimate
from clima_tpu.climate import load_evolve_file as ref_load_evolve_file
from clima_tpu.data import make_template_dir

from clima_tpu_torch.climate import Climate, load_evolve_file
from clima_tpu_torch.data import climate_settings_yaml_text, write_atmosphere_file
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, N_ZEN = 10, 2
T_EVAL = np.array([1.0e4, 5.0e4, 1.0e5])
STREAM = ("nz", "z", "nt", "t", "T", "f_total", "fup_ir", "fdn_ir", "fup_sol", "fdn_sol", "P")
FLUXES = ("f_total", "fup_ir", "fdn_ir", "fup_sol", "fdn_sol")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("template_climate"))
    t = make_template_dir(root, nz=NZ, n_zenith=N_ZEN)
    settings = os.path.join(root, "settings_climate.yaml")
    with open(settings, "w") as f:
        f.write(climate_settings_yaml_text(nz=NZ, n_zenith=N_ZEN))
    atmosphere = os.path.join(root, "atmosphere.txt")
    write_atmosphere_file(atmosphere)
    args = (t["species"], settings, t["star"], atmosphere, t["datadir"])
    ref, c = RefClimate(*args), Climate(*args, device="cpu")
    ref.verbose = c.verbose = False
    return ref, c


def _close_fluxes(got, want, rtol, err_msg=""):
    """Each flux array at rtol of its own largest value."""
    for g, w, name in zip(got, want, FLUXES):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * np.abs(w).max(),
                                   err_msg=f"{err_msg} {name}")


@pytest.fixture(scope="module")
def dop853_streams(models, tmp_path_factory):
    ref, c = models
    d = tmp_path_factory.mktemp("dop853")
    files = str(d / "ref.npz"), str(d / "port.npz")
    assert ref.evolve(files[0], 0.0, ref.T_init, T_EVAL, overwrite=True)
    assert c.evolve(files[1], 0.0, c.T_init, T_EVAL, overwrite=True)
    return files


def test_dop853_stream_matches_reference(models, dop853_streams):
    ref, c = models
    want, got = ref_load_evolve_file(dop853_streams[0]), load_evolve_file(dop853_streams[1])
    assert sorted(got) == sorted(want) == sorted(STREAM)
    for k in STREAM:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    assert got["T"].shape == (3, c.neq) and got["f_total"].shape == (3, c.nz + 1)
    assert int(got["nz"]) == NZ and int(got["nt"]) == 3
    np.testing.assert_allclose(got["T"], want["T"], rtol=1e-8)
    _close_fluxes([got[k] for k in FLUXES], [want[k] for k in FLUXES], 1e-8)
    for k in ("P", "z", "t"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    st = c.evolve_stats
    assert st["rejected"] == st["attempted"] - st["accepted"] >= 0 and st["accepted"] > 0
    assert st["rhs_evaluations"] > 12 * st["attempted"]  # DOP853: 12 stages an attempt


def test_evolve_files_load_in_either_package(dop853_streams):
    for fn in dop853_streams:
        got, want = load_evolve_file(fn), ref_load_evolve_file(fn)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def rk45_stream(models, tmp_path_factory):
    """The port's rk45_device stream over T_EVAL from T_init, and its stats."""
    _, c = models
    fn = str(tmp_path_factory.mktemp("rk45") / "rk45.npz")
    assert c.evolve(fn, 0.0, c.T_init, T_EVAL, overwrite=True, method="rk45_device")
    return fn, dict(c.evolve_stats)


def test_rk45_device_matches_dop853(dop853_streams, rk45_stream):
    fn, st = rk45_stream
    assert st["rhs_evaluations"] == 1 + 7 * st["attempted"] and st["accepted"] > 0
    got, want = load_evolve_file(fn), load_evolve_file(dop853_streams[1])
    assert sorted(got) == sorted(STREAM)
    for k in STREAM:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    np.testing.assert_allclose(got["T"], want["T"], rtol=1e-4, atol=1e-3)
    for k in FLUXES + ("P",):
        assert np.isfinite(got[k]).all(), k


def test_rk45_device_matches_reference(models, tmp_path, capsys):
    """The same step sequence as the JAX package's rk45_device (its step
    count, printed when verbose), and T at rtol 1e-8."""
    ref, c = models
    t_eval = np.logspace(3.0, 4.5, 3)
    files = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref.verbose = True
    try:
        assert ref.evolve(files[0], 0.0, ref.T_init, t_eval, overwrite=True,
                          method="rk45_device")
    finally:
        ref.verbose = False
    printed = capsys.readouterr().out
    assert c.evolve(files[1], 0.0, c.T_init, t_eval, overwrite=True, method="rk45_device")
    assert f"device RK45: {c.evolve_stats['attempted']} steps over 3 segments" in printed
    got, want = load_evolve_file(files[1]), ref_load_evolve_file(files[0])
    np.testing.assert_allclose(got["T"], want["T"], rtol=1e-8)
    _close_fluxes([got[k] for k in FLUXES], [want[k] for k in FLUXES], 1e-8)
    for k in ("P", "z", "t"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)


def test_rk45_device_rejects_a_non_finite_step(models, rk45_stream, tmp_path):
    """A stage that comes back NaN (heat_capacity outside its tables) makes
    its step a rejected one, shrunk by 0.2, and the integration goes on; held
    to the clean stream of the same inputs (rk45_stream)."""
    _, c = models
    build = c._build_device_fns
    calls = [0]

    def poisoned(T_freeze=None):
        rhs, fluxes_fn = build(T_freeze)

        def rhs_nan(T_in):
            calls[0] += 1
            out = rhs(T_in)
            return out * float("nan") if calls[0] == 3 else out  # 2nd stage, first attempt
        return rhs_nan, fluxes_fn

    fns = rk45_stream[0], str(tmp_path / "nan.npz")
    clean = rk45_stream[1]
    c._build_device_fns = poisoned
    try:
        assert c.evolve(fns[1], 0.0, c.T_init, T_EVAL, overwrite=True, method="rk45_device")
    finally:
        del c._build_device_fns
    assert c.evolve_stats["rejected"] >= clean["rejected"] + 1
    got, want = load_evolve_file(fns[1]), load_evolve_file(fns[0])
    assert np.isfinite(got["T"]).all()
    np.testing.assert_allclose(got["T"], want["T"], rtol=1e-4, atol=1e-3)
