"""The port's checkpoint and profiling utilities: the roundtrips of
tests/test_checkpoint.py on the port's AdiabatClimate, state and pytree files
written by each package and loaded by the other, and the timers and trace on
the CPU."""

import json
import os
import types

import numpy as np
import pytest
import torch

from clima_tpu.utils import checkpoint as ref_checkpoint

from clima_tpu_torch.adiabat import AdiabatClimate
from clima_tpu_torch.data import make_template
from clima_tpu_torch.utils import checkpoint
from clima_tpu_torch.utils.checkpoint import (load_pytree, load_state, restore_state,
                                              save_pytree, save_state)
from clima_tpu_torch.utils.profiling import Timer, time_fn, trace

PACKAGES = {"port": checkpoint, "jax": ref_checkpoint}


@pytest.fixture(scope="module")
def c():
    t = make_template(nz=12, n_zenith=1)
    c = AdiabatClimate(t["species"], t["settings"], t["star"], t["datadir"], device="cpu")
    c.verbose = False
    return c


def earth_P_i(c):
    P_i = np.full(c.sp.ng, 1.0e-15)
    P_i[c.species_names.index("H2O")] = 270.0e6
    P_i[c.species_names.index("N2")] = 1.0e6
    return P_i


def test_state_roundtrip(c, tmp_path):
    c.make_profile(280.0, earth_P_i(c))
    T_ref = c.T.copy()

    fn = str(tmp_path / "state.npz")
    save_state(c, fn)

    c.make_profile(300.0, earth_P_i(c))  # clobber
    assert not np.allclose(c.T, T_ref)
    restore_state(c, fn)
    np.testing.assert_allclose(c.T, T_ref, rtol=1e-14)
    assert c.T_surf == 280.0 and isinstance(c.T_surf, float)
    assert isinstance(c.T, np.ndarray) and c.convecting_with_below.dtype == bool


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_state_file_loads_in_the_other_package(c, tmp_path, writer, reader):
    c.make_profile(285.0, earth_P_i(c))
    want = {f: np.array(getattr(c, f)) for f in checkpoint._STATE_FIELDS}
    fn = str(tmp_path / "state.npz")
    PACKAGES[writer].save_state(c, fn)
    assert sorted(load_state(fn)) == sorted(ref_checkpoint.load_state(fn))

    c.make_profile(295.0, earth_P_i(c))
    PACKAGES[reader].restore_state(c, fn)
    for f, v in want.items():
        np.testing.assert_array_equal(getattr(c, f), v, err_msg=f)
    assert checkpoint._STATE_FIELDS == ref_checkpoint._STATE_FIELDS


def test_restore_state_checks_the_shape_and_keeps_tensors(c, tmp_path):
    fn = str(tmp_path / "state.npz")
    c.make_profile(280.0, earth_P_i(c))
    save_state(c, fn)
    other = types.SimpleNamespace(nz=c.nz + 1, sp=c.sp)
    with pytest.raises(ValueError, match="does not match"):
        restore_state(other, fn)

    # a model holding tensors gets tensors back, in its dtype
    held = types.SimpleNamespace(nz=c.nz, sp=c.sp, T=torch.zeros(c.nz, dtype=torch.float32),
                                 T_surf=0.0, P=np.zeros(c.nz))
    restore_state(held, fn)
    assert torch.is_tensor(held.T) and held.T.dtype == torch.float32
    np.testing.assert_allclose(held.T.numpy(), c.T.astype(np.float32))
    assert held.T_surf == 280.0 and isinstance(held.P, np.ndarray)
    # tensors are saved through the host
    save_state(held, str(tmp_path / "held.npz"))
    assert load_state(str(tmp_path / "held.npz"))["T"].dtype == np.float32


def test_pytree_roundtrip(tmp_path):
    tree = {"a": np.arange(5.0), "b": (np.ones((2, 3)), np.asarray(2.0))}
    fn = str(tmp_path / "tree.npz")
    save_pytree(tree, fn)
    out = load_pytree(fn, tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"][0], tree["b"][0])


def _unsorted_tree():
    """A nested dict with keys out of order, a list, a tuple and a None."""
    return {"zeta": [np.arange(3.0), (np.ones((2, 2)), np.asarray(7.0))],
            "alpha": {"m": np.array([1, 2], dtype=np.int32), "b": None, "a": np.zeros(4)},
            "mid": (np.full(2, 3.5),)}


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_pytree_file_loads_in_the_other_package(tmp_path, writer, reader):
    import jax

    tree = _unsorted_tree()
    fn = str(tmp_path / "tree.npz")
    PACKAGES[writer].save_pytree(tree, fn)
    out = PACKAGES[reader].load_pytree(fn, tree)
    want = jax.tree_util.tree_leaves(tree)
    got = jax.tree_util.tree_leaves(out)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == w.dtype
    assert sorted(out["alpha"]) == ["a", "b", "m"] and out["alpha"]["b"] is None
    with np.load(fn) as d:
        assert bytes(d["__treedef"]).decode() == str(jax.tree_util.tree_flatten(tree)[1])


def test_pytree_of_tensors(tmp_path):
    tree = {"y": torch.arange(4.0), "x": [torch.ones(2, dtype=torch.float32), 3.0]}
    fn = str(tmp_path / "tree.npz")
    save_pytree(tree, fn)
    with np.load(fn) as d:  # sorted keys: x's leaves first
        np.testing.assert_array_equal(d["leaf_0"], np.ones(2, dtype=np.float32))
        np.testing.assert_array_equal(d["leaf_2"], np.arange(4.0))
    out = load_pytree(fn, tree)
    assert torch.is_tensor(out["y"]) and torch.equal(out["y"], tree["y"])
    assert out["x"][0].dtype == torch.float32 and float(out["x"][1]) == 3.0


def test_timer_and_time_fn():
    with Timer() as t:
        sum(range(10000))
    assert t.elapsed > 0.0
    a = torch.ones(64, 64)
    dt = time_fn(lambda x: {"out": [x @ x]}, a, n_iter=3)
    assert 0.0 < dt < 10.0


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
