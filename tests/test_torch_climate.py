"""The time-stepping Climate model of the PyTorch port against clima_tpu's
(float64, CPU): the atmosphere file, the constructor's column, the host and
device right-hand sides, the DOP853 and rk45_device snapshot streams, files
read across the two packages, and the errors.

Both models are built from one template (nz=10, 2 zenith angles, the
atmosphere column and settings of tests/test_climate.py). The fluxes of the two packages
agree to ~1e-14 of the channel flux scale, 1.5e-13 at worst here (two-stream
solves and frequency sums in different orders), and dT/dt = dF/dz / (rho cp)
amplifies that roundoff by 1 / (rho cp dz), ~1e5 times more at the thin top
layer than at the ground. So dT/dt is held at rtol 1e-10 with a per-layer
atol: the tendency that a flux error of 1e-12 of the largest channel flux
would make there (:func:`_tendency_atol`).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clima_tpu import constants as ref_const
from clima_tpu.climate import Climate as RefClimate
from clima_tpu.climate import load_evolve_file as ref_load_evolve_file
from clima_tpu.climate.climate import CP_GROUND, DZ_GROUND, RHO_GROUND
from clima_tpu.config import AtmosphereFile as RefAtmosphereFile
from clima_tpu.config import unpack_atmospherefile as ref_unpack
from clima_tpu.config.species import heat_capacity as ref_heat_capacity
from clima_tpu.data import make_template_dir
from clima_tpu.physics import eqns as ref_eqns
from clima_tpu.utils.errors import ClimaException as RefClimaException

from clima_tpu_torch import ClimaException
from clima_tpu_torch.climate import Climate, load_evolve_file
from clima_tpu_torch.config import AtmosphereFile, unpack_atmospherefile
from clima_tpu_torch.data import climate_settings_yaml_text, write_atmosphere_file

NZ, N_ZEN = 10, 2
EPS_FLUX = 1e-12
T_EVAL = np.array([1.0e4, 5.0e4, 1.0e5])
STREAM = ("nz", "z", "nt", "t", "T", "f_total", "fup_ir", "fdn_ir", "fup_sol", "fdn_sol", "P")
FLUXES = ("f_total", "fup_ir", "fdn_ir", "fup_sol", "fdn_sol")


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("template_climate"))
    t = make_template_dir(root, nz=NZ, n_zenith=N_ZEN)
    t["settings_climate"] = os.path.join(root, "settings_climate.yaml")
    with open(t["settings_climate"], "w") as f:
        f.write(climate_settings_yaml_text(nz=NZ, n_zenith=N_ZEN))
    t["atmosphere"] = os.path.join(root, "atmosphere.txt")
    write_atmosphere_file(t["atmosphere"])
    return t


def _args(t, settings="settings_climate"):
    return t["species"], t[settings], t["star"], t["atmosphere"], t["datadir"]


@pytest.fixture(scope="module")
def models(template):
    ref = RefClimate(*_args(template))
    c = Climate(*_args(template), device="cpu")
    ref.verbose = c.verbose = False
    return ref, c


def perturbed(T_init):
    return T_init * (1.0 + 0.01 * np.sin(np.arange(len(T_init))))


def convective(T_init):
    """A state with superadiabatic lapse rates (~12 K/km, the adiabat's ~10),
    so that the mixing-length convection carries heat: from the ground into
    the first layer and from the first layer into the second."""
    T_in = T_init.copy()
    T_in[0] += 45.0
    T_in[2] = T_in[1] - 85.0
    return T_in


STATES = {"T_init": lambda T: T, "perturbed": perturbed, "convective": convective}


def _tendency_atol(ref, T_in, density):
    """Per entry of dT/dt, the tendency that a flux error of EPS_FLUX of the
    largest channel flux of ref's last radiative transfer would make: twice
    that error (dF/dz takes two edges) over the layer's rho * cp * dz, or the
    ground slab's."""
    w_ir, w_sol = ref.rad.wrk_ir, ref.rad.wrk_sol
    F = max(np.abs(a).max() for a in (w_ir.fup_n, w_ir.fdn_n, w_sol.fup_n, w_sol.fdn_n))
    cp_i = np.asarray(jnp.stack([ref_heat_capacity(ref.sp.thermo, t)
                                 for t in jnp.asarray(T_in[1:])]))
    cp = np.sum(cp_i * ref.mix, axis=1) / (ref.mubar * 1.0e-3) * 1.0e4
    rho = density / ref_const.N_avo * ref.mubar
    ground = RHO_GROUND * CP_GROUND * DZ_GROUND
    return 2.0 * EPS_FLUX * F / np.concatenate([[ground], rho * cp * ref.dz])


def _close_tendency(got, want, atol, rtol=1e-10):
    """dT/dt at rtol with the per-entry atol of :func:`_tendency_atol`."""
    err = np.abs(got - want)
    assert np.all(err <= atol + rtol * np.abs(want)), (err, atol)


def _close_fluxes(got, want, rtol, err_msg=""):
    """Each flux array at rtol of its own largest value."""
    for g, w, name in zip(got, want, FLUXES):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * np.abs(w).max(),
                                   err_msg=f"{err_msg} {name}")


def test_atmosphere_file_matches_reference(template, tmp_path):
    got, want = AtmosphereFile(template["atmosphere"]), RefAtmosphereFile(template["atmosphere"])
    assert got.labels == want.labels and got.nz == want.nz == 25
    for k in want.labels:
        np.testing.assert_array_equal(got.get(k), want.get(k))
    names = ["H2O", "CO2", "N2", "H2", "CH4", "CO", "O2"]
    z = np.linspace(-1.0e5, 8.0e6, 17)  # past both ends: constant extrapolation
    for g, w in zip(unpack_atmospherefile(got, names, z), ref_unpack(want, names, z)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(unpack_atmospherefile(got, names, z)[0].sum(axis=1), 1.0,
                               rtol=1e-15)
    with pytest.raises(ClimaException, match="not found"):
        got.get("NO2")

    bad = {"empty.txt": "\n1.0 2.0\n", "ragged.txt": "alt temp press\n1.0 2.0\n3.0 4.0\n"}
    for name, text in bad.items():
        path = str(tmp_path / name)
        with open(path, "w") as f:
            f.write(text)
        with pytest.raises(ClimaException) as e_got:
            AtmosphereFile(path)
        with pytest.raises(RefClimaException) as e_want:
            RefAtmosphereFile(path)
        assert str(e_got.value) == str(e_want.value)


def test_constructor_matches_reference(models):
    ref, c = models
    assert (c.nz, c.nz_r, c.neq, c.rad.nz) == (ref.nz, ref.nz_r, ref.neq, ref.rad.nz)
    assert c.nz_r == 2 * NZ and c.double_radiative_grid
    assert (c.rtol, c.atol, c.surface_pressure) == (ref.rtol, ref.atol, ref.surface_pressure)
    for k in ("z", "dz", "z_r", "dz_r", "grav", "mix", "T_init", "mubar"):
        np.testing.assert_allclose(getattr(c, k), getattr(ref, k), rtol=1e-14, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("state", list(STATES))
def test_right_hand_side_matches_reference(models, state):
    ref, c = models
    T_in = STATES[state](ref.T_init)
    ref._P = c._P = None  # the hydrostatic state freezes at this call's T
    want = ref.right_hand_side(T_in)
    got = c.right_hand_side(T_in)
    np.testing.assert_allclose(c._P, ref._P, rtol=1e-14)
    assert got.shape == (c.neq,) and np.isfinite(got).all()
    _close_tendency(got, want, _tendency_atol(ref, T_in, ref._density))
    np.testing.assert_allclose(c.rad.f_total, ref.rad.f_total, rtol=0,
                               atol=EPS_FLUX * np.abs(ref.rad.wrk_ir.fup_n).max())


def test_device_fns_match_reference(models):
    """The device RHS and fluxes frozen at T_freeze != T_init, against the
    JAX package's jitted ones; fluxes_fn over two columns at once."""
    import jax

    ref, c = models
    T_freeze = ref.T_init + 3.0
    T_in = convective(ref.T_init)
    rhs_ref, fluxes_ref = ref._build_device_fns(T_freeze=T_freeze)
    rhs, fluxes_fn = c._build_device_fns(T_freeze=T_freeze)

    want = np.asarray(jax.jit(rhs_ref)(jnp.asarray(T_in)))
    got = rhs(torch.tensor(T_in)).numpy()
    _, density = ref_eqns.press_and_den(jnp.asarray(T_freeze[1:]), jnp.asarray(ref.grav),
                                        ref.surface_pressure * 1.0e6, jnp.asarray(ref.dz),
                                        jnp.asarray(ref.mubar))
    ref.right_hand_side(T_in)  # the flux scale of this state, for the atol
    _close_tendency(got, want, _tendency_atol(ref, T_in, np.asarray(density)))

    states = np.stack([T_in, T_freeze])
    got = fluxes_fn(torch.tensor(states[:, 0]), torch.tensor(states[:, 1:]))
    for b, y in enumerate(states):
        want = jax.jit(fluxes_ref)(y[0], jnp.asarray(y[1:]))
        _close_fluxes([g[b].numpy() for g in got], want, 1e-10, f"column {b}")
        assert all(g.shape == (2, c.nz_r + 1) for g in got)


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


def test_rk45_device_matches_dop853(models, dop853_streams, tmp_path):
    _, c = models
    fn = str(tmp_path / "rk45.npz")
    assert c.evolve(fn, 0.0, c.T_init, T_EVAL, overwrite=True, method="rk45_device")
    st = c.evolve_stats
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


def test_rk45_device_rejects_a_non_finite_step(models, tmp_path):
    """A stage that comes back NaN (heat_capacity outside its tables) makes
    its step a rejected one, shrunk by 0.2, and the integration goes on."""
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

    fns = str(tmp_path / "clean.npz"), str(tmp_path / "nan.npz")
    assert c.evolve(fns[0], 0.0, c.T_init, T_EVAL, overwrite=True, method="rk45_device")
    clean = dict(c.evolve_stats)
    c._build_device_fns = poisoned
    try:
        assert c.evolve(fns[1], 0.0, c.T_init, T_EVAL, overwrite=True, method="rk45_device")
    finally:
        del c._build_device_fns
    assert c.evolve_stats["rejected"] >= clean["rejected"] + 1
    got, want = load_evolve_file(fns[1]), load_evolve_file(fns[0])
    assert np.isfinite(got["T"]).all()
    np.testing.assert_allclose(got["T"], want["T"], rtol=1e-4, atol=1e-3)


def test_evolve_errors(models, tmp_path):
    ref, c = models
    fn = str(tmp_path / "x.npz")
    with pytest.raises(ClimaException, match="wrong dimension"):
        c.evolve(fn, 0.0, c.T_init[1:], T_EVAL, overwrite=True)
    open(fn, "w").close()
    with pytest.raises(ClimaException, match="already exists"):
        c.evolve(fn, 0.0, c.T_init, T_EVAL)
    with pytest.raises(ClimaException, match="wrong dimension"):  # shape comes first
        c.evolve(fn, 0.0, c.T_init[1:], T_EVAL, method="rk99")
    with pytest.raises(ClimaException, match="already exists"):  # then the file
        c.evolve(fn, 0.0, c.T_init, T_EVAL, method="rk99")
    with pytest.raises(ClimaException, match="unknown evolve method"):
        c.evolve(fn, 0.0, c.T_init, np.array([10.0]), overwrite=True, method="rk99")
    for t_eval in (np.array([1.0e3, 1.0e3]), np.array([2.0e3, 1.0e3]), np.array([0.0])):
        with pytest.raises(ClimaException, match="strictly increasing"):
            c.evolve(fn, 0.0, c.T_init, t_eval, overwrite=True, method="rk45_device")
        with pytest.raises(RefClimaException, match="strictly increasing"):
            ref.evolve(fn, 0.0, ref.T_init, t_eval, overwrite=True, method="rk45_device")


@pytest.mark.parametrize("missing", ["bottom/top", "surface-pressure"])
def test_settings_without_grid_or_surface_pressure_raise(template, tmp_path, missing):
    text = (climate_settings_yaml_text(NZ, N_ZEN, bottom=None, top=None)
            if missing == "bottom/top" else
            climate_settings_yaml_text(NZ, N_ZEN, surface_pressure=None))
    path = str(tmp_path / "settings.yaml")
    with open(path, "w") as f:
        f.write(text)
    t = dict(template, bad=path)
    with pytest.raises(ClimaException) as e_got:
        Climate(*_args(t, "bad"), device="cpu")
    with pytest.raises(RefClimaException) as e_want:
        RefClimate(*_args(t, "bad"))
    assert str(e_got.value) == str(e_want.value)


def test_no_device_without_a_card_raises(template, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Climate(*_args(template))
