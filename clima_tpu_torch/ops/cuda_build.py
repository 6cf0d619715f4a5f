"""Build and load the package's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source becomes a shared library with a plain C interface, bound with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries are built
on first use into ``clima_tpu_torch/_build/`` (not tracked by git), named by
a hash of the source and flags, and reused by later processes of the same
checkout. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from ..utils.shared_library import build_shared

__all__ = ["load_library", "BUILD_INFO"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()  # guards _LOCKS
_LOCKS = {}  # library name -> its build lock, so different libraries build in parallel
_LIBS = {}
# name -> {"seconds": build time (0.0 when reused), "log": nvcc's output}
BUILD_INFO = {}

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# library -> {C entry point: argtypes}
_SIGNATURES = {
    "twostream": {
        "clima_twostream_weighted": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _LL,
                                     _I, _I, _D, _P, _P, _P, _P, _P],
        "clima_twostream_solar_max_group": [_I, _I],
        "clima_twostream_solar_multi": [_I, _I, _P, _P, _P, _P, _P, _I, _LL, _I, _P, _P, _P, _P,
                                        _P, _P],
    },
    "rorr": {"clima_rorr_chain": [_I, _I, _I, _LL, _P, _P, _P, _P, _P]},
    "march": {"clima_march": [_I, _I, _I, _I, _I, _I, _I] + [_P] * 16},
}
# library -> flags beyond _FLAGS. The march kernel repeats its twin's arithmetic
# operation by operation, so it is built without contracting a product and a
# sum into one rounding (a fused multiply-add), which no tensor operation does.
_EXTRA_FLAGS = {"march": ["-fmad=false"]}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def load_library(name):
    """The ctypes entry points of kernel library ``name`` ("twostream",
    "rorr" or "march") as a dict {C function name: function}, building
    ``csrc/<name>.cu`` first if needed. Different libraries may build
    concurrently."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        out, seconds, log = build_shared(_nvcc(), _FLAGS + _EXTRA_FLAGS.get(name, []),
                                         os.path.join(_CSRC, name + ".cu"), f"lib{name}")
        BUILD_INFO[name] = {"seconds": seconds, "log": log}
        lib = ctypes.CDLL(out)
        fns = {}
        for fname, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[fname] = fn
        _LIBS[name] = fns
        return fns
