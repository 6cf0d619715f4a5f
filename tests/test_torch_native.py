"""The PyTorch port's native futils library (csrc/futils.cpp, built with g++
and bound with ctypes in clima_tpu_torch.ops.rebin) against numpy references
of the same semantics, and ``rebin_with_errors`` against
clima_tpu.ops.rebin's (float64, CPU)."""

import types

import numpy as np
import pytest
import torch

from clima_tpu.ops.rebin import rebin_with_errors as ref_rebin_with_errors

import clima_tpu_torch
from clima_tpu_torch.ops import rebin as rb
from clima_tpu_torch.utils import shared_library
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse: one CPU thread)


def random_edges(rng, n, lo, hi):
    return np.sort(rng.uniform(lo, hi, n + 1)) + np.arange(n + 1) * 1e-9


def numpy_rebin(old_bins, old_vals, new_bins):
    """rebin through the cumulative integral of the piecewise-constant function."""
    F = np.concatenate([[0.0], np.cumsum(old_vals * np.diff(old_bins))])
    Fe = np.interp(np.clip(new_bins, old_bins[0], old_bins[-1]), old_bins, F)
    return np.diff(Fe) / np.diff(new_bins)


def numpy_inter2(xg, x, y):
    """inter2 through the cumulative integral of the linear interpolant."""
    F = np.concatenate([[0.0], np.cumsum(0.5 * (y[1:] + y[:-1]) * np.diff(x))])
    idx = np.clip(np.searchsorted(x, xg, side="right") - 1, 0, len(x) - 2)
    x0, x1, y0, y1 = x[idx], x[idx + 1], y[idx], y[idx + 1]
    t = np.where(x1 > x0, (xg - x0) / np.where(x1 == x0, 1.0, x1 - x0), 0.0)
    Fe = F[idx] + 0.5 * (y0 + y0 + t * (y1 - y0)) * (xg - x0)
    return np.diff(Fe) / np.diff(xg)


def test_native_rebin_matches_numpy():
    rng = np.random.default_rng(0)
    for _ in range(20):
        old = random_edges(rng, rng.integers(2, 50), 0.0, 10.0)
        new = random_edges(rng, rng.integers(2, 30), -1.0, 11.0)
        vals = rng.uniform(-5.0, 5.0, len(old) - 1)
        np.testing.assert_allclose(rb.rebin(old, vals, new), numpy_rebin(old, vals, new),
                                   rtol=1e-12, atol=1e-12)


def test_native_inter2_matches_numpy():
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(-5.0, 25.0, 60))
    x[0], x[-1] = -5.0, 25.0
    y = rng.uniform(0.0, 3.0, 60)
    xg = np.linspace(0.0, 20.0, 9)
    np.testing.assert_allclose(rb.inter2(xg, x, y), numpy_inter2(xg, x, y), rtol=1e-12)


def test_native_library_is_built_once_into_the_build_dir():
    lib = rb._native_lib()
    assert lib is rb._native_lib()
    assert lib._name.startswith(shared_library.BUILD_DIR) and "-march=native" not in rb._FLAGS


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "futils.cpp"
    bad.write_text('extern "C" int clima_rebin( { }\n')
    monkeypatch.setattr(rb, "_SRC", str(bad))
    monkeypatch.setattr(shared_library, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(rb, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        rb._native_lib()
    assert "error" in str(err.value)


@pytest.mark.parametrize("call", [
    lambda: rb.rebin([0.0], [], [0.0, 1.0]),
    lambda: rb.rebin([0.0, 1.0], [1.0], [0.0]),
    lambda: rb.rebin([0.0, 1.0, 2.0], [[1.0, 2.0]], [0.0, 1.0]),
    lambda: rb.inter2([0.0], [0.0, 1.0], [1.0, 2.0]),
    lambda: rb.inter2([0.0, 1.0], [0.0], [1.0]),
    lambda: rb.inter2([0.0, 0.5, 0.5, 1.0], [0.0, 1.0], [1.0, 2.0]),
], ids=["rebin_no_old_bin", "rebin_no_new_bin", "rebin_2d_values", "inter2_no_bin",
        "inter2_one_point", "inter2_empty_bin"])
def test_inputs_the_library_refuses_raise_before_the_call(call, monkeypatch):
    """Empty grids, rows of values and empty bins raise ValueError in Python
    and never reach the library."""
    monkeypatch.setattr(rb, "_LIB", None)
    monkeypatch.setattr(rb, "_native_lib", lambda: pytest.fail("reached the library"))
    with pytest.raises(ValueError):
        call()


def test_non_zero_library_status_raises(monkeypatch):
    """A non-zero status from the library raises; there is no numpy fallback."""
    refuse = types.SimpleNamespace(clima_rebin=lambda *a: 2, clima_inter2=lambda *a: 3)
    monkeypatch.setattr(rb, "_native_lib", lambda: refuse)
    with pytest.raises(RuntimeError, match="clima_rebin returned status 2"):
        rb.rebin([0.0, 1.0], [1.0], [0.0, 1.0])
    with pytest.raises(RuntimeError, match="clima_inter2 returned status 3"):
        rb.inter2([0.0, 1.0], [0.0, 1.0], [1.0, 2.0])


def test_rebin_with_errors_matches_reference():
    rng = np.random.default_rng(2)
    for _ in range(10):
        old = random_edges(rng, rng.integers(2, 40), 0.0, 10.0)
        new = random_edges(rng, rng.integers(2, 20), -1.0, 11.0)
        vals, errs = rng.uniform(-5.0, 5.0, len(old) - 1), rng.uniform(0.0, 1.0, len(old) - 1)
        got = clima_tpu_torch.rebin_with_errors(old, vals, errs, new)
        want = ref_rebin_with_errors(old, vals, errs, new)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12, atol=1e-12)
