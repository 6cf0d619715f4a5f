"""Host layer of the PyTorch port against clima_tpu: settings and species
parsing, OpticalData/channel/stellar-flux loaders, the in-memory synthetic
template, closed-form physics and host regridding (float64)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from clima_tpu.data import make_template_dir
from clima_tpu.config import load_settings as ref_load_settings, load_species as ref_load_species
from clima_tpu.physics import eqns as ref_eqns
from clima_tpu.ops import interp as ref_interp
from clima_tpu.ops import rebin as ref_rebin
from clima_tpu.radtran import data as ref_data

from clima_tpu_torch import ClimaException
from clima_tpu_torch.config import (
    load_settings,
    load_species,
    settings_from_dict,
    species_from_dict,
)
from clima_tpu_torch.data import make_template, make_template_dir as port_make_template_dir
from clima_tpu_torch.physics import eqns
from clima_tpu_torch.ops import interp, rebin
from clima_tpu_torch.radtran import data
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


RTOL = 1e-14


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    return make_template_dir(str(tmp_path_factory.mktemp("tpl")), nz=12, n_zenith=2,
                             particles=True)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want, path="op"):
    """Field-by-field equality of a port dataclass and a reference one:
    arrays to RTOL, everything else exactly."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, list) and want and dataclasses.is_dataclass(want[0]):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, torch.Tensor)):
        np.testing.assert_allclose(_host(got), _host(want), rtol=RTOL, atol=0, err_msg=path)
    else:
        assert got == want, path


def _settings(template):
    return ref_load_settings(template["settings"]), load_settings(template["settings"])


def _names(template):
    return ref_load_species(template["species"]).gas_names, ["HCaer"]


def test_settings_and_species_match_reference(template):
    ref_s, s = _settings(template)
    assert dataclasses.asdict(s) == dataclasses.asdict(ref_s)
    ref_sp, sp = ref_load_species(template["species"]), load_species(template["species"])
    assert sp.gas_names == ref_sp.gas_names and sp.particle_names == ref_sp.particle_names
    np.testing.assert_array_equal(sp.gas_masses, ref_sp.gas_masses)
    for f in ("temps", "coeffs", "model"):
        np.testing.assert_array_equal(getattr(sp.thermo, f), np.asarray(getattr(ref_sp.thermo, f)))
    for i, d in enumerate(sp.sat):
        if d is None:
            assert not bool(ref_sp.sat.has_sat[i])
        else:
            assert float(ref_sp.sat.P_ref[i]) == d["P_ref"]


def test_settings_reject_bad_input():
    with pytest.raises(ClimaException):
        settings_from_dict({"optical-properties": {"k-method": "Nope"}})
    with pytest.raises(ClimaException):
        settings_from_dict({"planet": {"planet-mass": -1.0, "planet-radius": 1.0}})
    with pytest.raises(ClimaException):
        species_from_dict({"atoms": [], "species": []})


def test_optical_data_channels_and_star_match_reference(template):
    # both packages regrid 1-D data with their native C++ merge sweeps
    # (ops.rebin's numpy branch differs from them in the last bits)
    ref_s, s = _settings(template)
    gases, parts = _names(template)
    ref_op = ref_data.load_optical_data(template["datadir"], gases, parts, ref_s.op)
    op = data.load_optical_data(template["datadir"], gases, parts, s.op, device="cpu")
    assert op.part and op.cont is not None and op.cia and op.pxs and op.ray
    assert_same(op, ref_op)
    assert op.opacities2yaml() == ref_op.opacities2yaml()
    for kind in ("ir", "solar"):
        assert_same(data.load_channel(template["datadir"], kind, None, op),
                    ref_data.load_channel(template["datadir"], kind, None, ref_op), kind)
    ref_sol = ref_data.load_channel(template["datadir"], "solar", None, ref_op)
    np.testing.assert_allclose(data.read_stellar_flux(template["star"], ref_sol.wavl),
                               ref_data.read_stellar_flux(template["star"], ref_sol.wavl),
                               rtol=RTOL, atol=0)

    # tables handed over from the reference's own loaders
    ref_ir = ref_data.load_channel(template["datadir"], "ir", None, ref_op)
    op2, ir2, sol2 = data.optical_data_from_numpy(ref_op, ref_ir, ref_sol, "cpu", torch.float64)
    assert_same(op2, ref_op)
    assert_same(ir2, ref_ir, "ir")
    assert_same(sol2, ref_sol, "sol")


def test_in_memory_template_equals_files(template, tmp_path):
    import h5py
    import yaml

    mem = make_template(nz=12, n_zenith=2, particles=True)
    root = template["datadir"]
    files = sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )
    assert files == sorted(mem["datadir"])
    for rel in files:
        path = os.path.join(root, rel)
        if rel.endswith(".h5"):
            with h5py.File(path, "r") as f:
                assert sorted(f.keys()) == sorted(mem["datadir"][rel]), rel
                for k in f.keys():
                    np.testing.assert_array_equal(mem["datadir"][rel][k], f[k][()], err_msg=rel)
        else:
            with open(path) as f:
                assert yaml.safe_load(f) == mem["datadir"][rel], rel
    np.testing.assert_array_equal(mem["star"], np.loadtxt(template["star"], skiprows=1))
    s_file = dataclasses.asdict(load_settings(template["settings"]))
    s_mem = dataclasses.asdict(mem["settings"])
    s_file.pop("filename"), s_mem.pop("filename")
    assert s_mem == s_file
    sp_file, sp_mem = load_species(template["species"]), species_from_dict(mem["species"])
    assert sp_mem.gas_names == sp_file.gas_names and sp_mem.sat == sp_file.sat
    np.testing.assert_array_equal(sp_mem.thermo.coeffs, sp_file.thermo.coeffs)

    # the port's own writer produces the same files
    port = port_make_template_dir(str(tmp_path), nz=12, n_zenith=2, particles=True)
    for key in ("species", "settings", "star"):
        with open(port[key]) as f1, open(template[key]) as f2:
            assert f1.read() == f2.read(), key
    for rel in files:
        if rel.endswith(".h5"):
            with h5py.File(os.path.join(port["datadir"], rel), "r") as f:
                for k, v in mem["datadir"][rel].items():
                    np.testing.assert_array_equal(f[k][()], v, err_msg=rel)

    gases, parts = _names(template)
    op_mem = data.load_optical_data(mem["datadir"], gases, parts, mem["settings"].op,
                                    device="cpu")
    op_file = data.load_optical_data(root, gases, parts, mem["settings"].op, device="cpu")
    assert_same(op_mem, op_file)
    assert_same(data.load_channel(mem["datadir"], "ir", None, op_mem),
                data.load_channel(root, "ir", None, op_file))


def test_eqns_match_reference():
    rng = np.random.default_rng(0)
    nu = rng.uniform(1e12, 1e15, 17)
    T = rng.uniform(150.0, 400.0, 17)
    t = torch.tensor
    np.testing.assert_allclose(eqns.planck_fcn(t(nu), t(T)).numpy(),
                               np.asarray(ref_eqns.planck_fcn(jnp.asarray(nu), jnp.asarray(T))),
                               rtol=1e-13)
    for n in (1, 4, 8):
        for a, b in zip(eqns.zenith_angles_and_weights(n), ref_eqns.zenith_angles_and_weights(n)):
            np.testing.assert_array_equal(a, b)
    w = rng.uniform(0.1, 1.0, 8)
    np.testing.assert_allclose(eqns.weights_to_bins(w), np.asarray(ref_eqns.weights_to_bins(w)),
                               rtol=1e-14)
    assert eqns.rayleigh_vardavas(2.9e-4, 7.7e-3, 0.03, 550.0) == pytest.approx(
        float(ref_eqns.rayleigh_vardavas(2.9e-4, 7.7e-3, 0.03, 550.0)), rel=1e-14)
    z, dz = eqns.vertical_grid(0.0, 7e6, 20)
    Tz = 288.0 - 6.5e-5 * z
    grav = eqns.gravity(6.371e8, 5.972e27, z)
    np.testing.assert_allclose(grav, np.asarray(ref_eqns.gravity(6.371e8, 5.972e27, z)), rtol=1e-14)
    got = eqns.press_and_den(t(Tz), t(grav), 1.013e6, t(dz), t(np.full(20, 28.6)))
    want = ref_eqns.press_and_den(jnp.asarray(Tz), jnp.asarray(grav), 1.013e6, jnp.asarray(dz),
                                  jnp.asarray(np.full(20, 28.6)))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13)
    coeffs = rng.uniform(-5, 5, (3, 9))
    Tc = rng.uniform(200.0, 1000.0, 3)
    for f in ("heat_capacity_shomate", "heat_capacity_nasa9"):
        np.testing.assert_allclose(getattr(eqns, f)(t(coeffs), t(Tc)).numpy(),
                                   np.asarray(getattr(ref_eqns, f)(jnp.asarray(coeffs), jnp.asarray(Tc))),
                                   rtol=1e-13)
    dTdz = rng.uniform(-2e-4, 1e-4, 30)
    adiabat = np.full(30, 9.8e-5)
    np.testing.assert_allclose(
        eqns.eddy_for_heat(1e5, 981.0, t(np.full(30, 250.0)), t(dTdz), t(adiabat)).numpy(),
        np.asarray(ref_eqns.eddy_for_heat(1e5, 981.0, jnp.full(30, 250.0), jnp.asarray(dTdz),
                                          jnp.asarray(adiabat))),
        rtol=1e-13)
    assert eqns.skin_temperature(1361.0, 0.3) == pytest.approx(
        float(ref_eqns.skin_temperature(1361.0, 0.3)), rel=1e-15)
    k = eqns.k_term_heat_redistribution(2.5e10, 981.0, 0.5, 28.0, 1e7, 2.0, 1e-3)
    assert k == pytest.approx(
        float(ref_eqns.k_term_heat_redistribution(2.5e10, 981.0, 0.5, 28.0, 1e7, 2.0, 1e-3)), rel=1e-14)
    assert eqns.f_heat_redistribution(1.0, 1e6, 255.0, k) == pytest.approx(
        float(ref_eqns.f_heat_redistribution(1.0, 1e6, 255.0, k)), rel=1e-14)


def test_interp_matches_reference():
    rng = np.random.default_rng(2)
    grid = np.sort(rng.uniform(100.0, 400.0, 9))
    x = rng.uniform(50.0, 450.0, (3, 11))  # includes clamped samples
    x[0, 0] = grid[3]  # a sample exactly on a node
    W = interp.hat_weights(torch.tensor(grid), torch.tensor(x))
    np.testing.assert_allclose(W.numpy(), np.asarray(ref_interp.hat_weights(grid, jnp.asarray(x))),
                               rtol=1e-14, atol=1e-15)
    np.testing.assert_array_equal(
        interp.searchsorted_right(torch.tensor(grid), torch.tensor(x)).numpy(),
        np.asarray(ref_interp.searchsorted_right(jnp.asarray(grid), jnp.asarray(x))))
    tab = rng.uniform(-1.0, 1.0, (9, 5))
    np.testing.assert_allclose(interp.pdot(W, torch.tensor(tab)).numpy(),
                               np.asarray(ref_interp.pdot(ref_interp.hat_weights(grid, jnp.asarray(x)),
                                                          jnp.asarray(tab))), rtol=1e-13, atol=1e-15)


def test_host_regridding_matches_reference():
    rng = np.random.default_rng(1)
    old = np.cumsum(rng.uniform(0.1, 1.0, 31))
    vals = rng.uniform(0.0, 5.0, 30)
    new = np.linspace(old[0] - 1.0, old[-1] + 1.0, 17)
    np.testing.assert_allclose(rebin.rebin(old, vals, new), ref_rebin.rebin(old, vals, new),
                               rtol=1e-12, atol=1e-14)
    x = np.concatenate([[0.0], np.cumsum(rng.uniform(0.1, 1.0, 40))])
    y = rng.uniform(-3.0, 3.0, 41)
    xg = np.linspace(1.0, 3.5, 12)
    np.testing.assert_allclose(rebin.inter2(xg, x, y), ref_rebin.inter2(xg, x, y),
                               rtol=1e-12, atol=1e-14)
    xp = np.sort(rng.uniform(2.0, 20.0, 25))
    for mode, fill in (("Constant", None), ("FillValue", -7.0)):
        np.testing.assert_allclose(
            rebin.interp_discrete_to_bins(xg, xp, y[:25], mode, fill),
            ref_rebin.interp_discrete_to_bins(xg, xp, y[:25], mode, fill), rtol=1e-12, atol=1e-14)
    xa, ya = rebin.addpnt(x, y, 5.5, 9.0)
    xb, yb = ref_rebin.addpnt(x, y, 5.5, 9.0)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)
    with pytest.raises(ValueError):
        rebin.rebin(old[::-1], vals, new)
