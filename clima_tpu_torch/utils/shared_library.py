"""Build a shared library from one source file into ``clima_tpu_torch/_build/``.

The CUDA kernels (:mod:`..ops.cuda_build`, ``nvcc``) and the native host
numerics (:mod:`..ops.rebin`, ``g++``) are both built this way: on first
use, named by a hash of the source and flags, and reused by later processes
of the same checkout. ``_build/`` is not tracked by git.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time

__all__ = ["BUILD_DIR", "build_shared"]

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def build_shared(compiler, flags, src, stem):
    """Path of the shared library ``_build/<stem>-<hash>.so`` built from
    ``src`` by ``compiler`` with ``flags``, named by a hash of the source and
    flags; builds it first if it is missing (a failed build raises with the
    compiler's output). Returns (path, build seconds (0.0 when reused), the
    compiler's output)."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        res = subprocess.run([compiler, *flags, "-o", tmp, src], capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed on {src}:\n{log}")
        os.replace(tmp, out)
    return out, time.perf_counter() - t0, log
