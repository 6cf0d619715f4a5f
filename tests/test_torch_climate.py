"""The time-stepping Climate model of the PyTorch port against clima_tpu's
(float64, CPU): the atmosphere file, the constructor's column, the host and
device right-hand sides, and the errors. The DOP853 and rk45_device snapshot
streams, and their files read across the two packages, are in
test_torch_climate_evolve.py (a file of its own, so that the test workers
run it beside this one).

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
from clima_tpu.climate.climate import CP_GROUND, DZ_GROUND, RHO_GROUND
from clima_tpu.config import AtmosphereFile as RefAtmosphereFile
from clima_tpu.config import unpack_atmospherefile as ref_unpack
from clima_tpu.config.species import heat_capacity as ref_heat_capacity
from clima_tpu.data import make_template_dir
from clima_tpu.physics import eqns as ref_eqns
from clima_tpu.utils.errors import ClimaException as RefClimaException

from clima_tpu_torch import ClimaException
from clima_tpu_torch.climate import Climate
from clima_tpu_torch.config import AtmosphereFile, unpack_atmospherefile
from clima_tpu_torch.data import climate_settings_yaml_text, write_atmosphere_file
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


NZ, N_ZEN = 10, 2
EPS_FLUX = 1e-12
T_EVAL = np.array([1.0e4, 5.0e4, 1.0e5])
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
