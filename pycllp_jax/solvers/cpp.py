"""Native C++ HSD backend via ctypes.

The framework's equivalent of the upstream Cython-wrapped Vanderbei C
solver (SURVEY.md §2.2 — language boundary at §3.3: control crosses
Python→native once per ``solve``, no callbacks).  The shared library is
built on demand from ``pycllp_jax/native/hsd_native.cpp`` with g++
(-O3 -fopenmp) and cached next to the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from pycllp_jax.solvers.base import BaseSolver, register_solver
from pycllp_jax.solvers.options import Solution

__all__ = ["CppHSDSolver", "load_native"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "hsd_native.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libpycllp_native.so")
_lock = threading.Lock()
_lib = None


def _build() -> None:
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-fopenmp",
        "-o",
        _LIB,
        _SRC,
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def load_native():
    """Build (if stale) and load the native library; returns ctypes lib."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB)
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.hsd_solve_batch.restype = ctypes.c_int
        lib.hsd_solve_batch.argtypes = [
            dp, dp, dp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            dp, dp, dp, ip, ip,
        ]
        lib.hsd_native_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


@register_solver
class CppHSDSolver(BaseSolver):
    """Batched HSD on the native C++ backend (f64, OpenMP over instances)."""

    name = "cpp_hsd"
    aliases = ("cyhsd", "cpp")

    @classmethod
    def is_available(cls) -> bool:
        try:
            load_native()
            return True
        except Exception:
            return False

    def _solve_impl(self, A, b, c) -> Solution:
        lib = load_native()
        if A.ndim == 3:
            raise ValueError("cpp_hsd requires shared (2-D) A")
        m, n = A.shape
        B = b.shape[0]
        A = np.ascontiguousarray(A, np.float64)
        b = np.ascontiguousarray(b, np.float64)
        c = np.ascontiguousarray(c, np.float64)
        x = np.zeros((B, n))
        y = np.zeros((B, m))
        obj = np.zeros(B)
        status = np.zeros(B, np.int32)
        iters = np.zeros(B, np.int32)
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)
        o = self.options
        ret = lib.hsd_solve_batch(
            A.ctypes.data_as(dp),
            b.ctypes.data_as(dp),
            c.ctypes.data_as(dp),
            m, n, B,
            o.tol, o.maxiter, o.alpha0, o.resolved_reg_eps(np.float64),
            x.ctypes.data_as(dp),
            y.ctypes.data_as(dp),
            obj.ctypes.data_as(dp),
            status.ctypes.data_as(ip),
            iters.ctypes.data_as(ip),
        )
        if ret != 0:  # pragma: no cover
            raise RuntimeError(f"native solver returned {ret}")
        z = c - y @ A  # reduced costs at the recovered point
        return Solution(
            x=x, y=y, z=z, objective=obj, status=status, iterations=iters
        )
