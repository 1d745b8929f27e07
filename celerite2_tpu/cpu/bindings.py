"""ctypes bindings for the native CPU driver.

The shared library is built on first use (g++ -O3) and cached next to
the source; no pybind11 required.  API mirrors the reference driver's
in-place NumPy semantics (python/celerite2/driver.cpp:482-499): outputs
are written into caller-provided arrays and returned.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from celerite2_tpu.utils import LinAlgError

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "driver.cpp")
_LIB = os.path.join(_HERE, "libcelerite2_cpu.so")
_lock = threading.Lock()
_lib = None

_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def _build():
    # build to a private name, then rename: concurrent first uses (e.g.
    # parallel test workers) never load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++",
        "-O3",
        "-fPIC",
        "-shared",
        "-std=c++17",
        "-march=native",
        _SRC,
        "-o",
        tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(
            _LIB
        ) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB)

        lib.celerite2_factor.restype = _i64
        lib.celerite2_factor.argtypes = [
            _i64, _i64, _f64, _f64, _f64, _f64, _f64, _f64, _f64,
        ]
        for name in (
            "celerite2_solve_lower",
            "celerite2_solve_upper",
            "celerite2_matmul_lower",
            "celerite2_matmul_upper",
        ):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                _i64, _i64, _i64, _f64, _f64, _f64, _f64, _f64, _f64,
            ]
        for name in (
            "celerite2_general_matmul_lower",
            "celerite2_general_matmul_upper",
        ):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                _i64, _i64, _i64, _i64,
                _f64, _f64, _f64, _f64, _f64, _f64, _f64,
            ]
        lib.celerite2_matrices.restype = None
        lib.celerite2_matrices.argtypes = [
            _i64, _i64, _i64,
            _f64, _f64, _f64, _f64, _f64, _f64,
            _f64, _f64, _f64, _f64, _f64, _f64,
        ]
        _lib = lib
        return _lib


def _c(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64))


class _Driver:
    """In-place NumPy ops over the native core (reference driver parity)."""

    def factor(self, t, c, a, U, V, d_out=None, W_out=None):
        t, c, a, U, V = map(_c, (t, c, a, U, V))
        N, J = U.shape
        d = d_out if d_out is not None else np.empty(N)
        W = W_out if W_out is not None else np.empty((N, J))
        flag = _get_lib().celerite2_factor(N, J, t, c, a, U, V, d, W)
        if flag:
            raise LinAlgError(
                f"failed to factorize matrix at row {flag - 1}"
            )
        return d, W

    def _sweep(self, name, t, c, A, B, Y):
        t, c, A, B = map(_c, (t, c, A, B))
        Y = _c(Y)
        squeeze = Y.ndim == 1
        if squeeze:
            Y = Y[:, None]
        N, J = A.shape
        K = Y.shape[1]
        Z = np.empty_like(Y)
        getattr(_get_lib(), name)(N, J, K, t, c, A, B, Y, Z)
        return Z[:, 0] if squeeze else Z

    def solve_lower(self, t, c, U, W, Y):
        return self._sweep("celerite2_solve_lower", t, c, U, W, Y)

    def solve_upper(self, t, c, U, W, Y):
        return self._sweep("celerite2_solve_upper", t, c, U, W, Y)

    def matmul_lower(self, t, c, U, V, Y):
        return self._sweep("celerite2_matmul_lower", t, c, U, V, Y)

    def matmul_upper(self, t, c, U, V, Y):
        return self._sweep("celerite2_matmul_upper", t, c, U, V, Y)

    def _general(self, name, t1, t2, c, U, V, Y):
        t1, t2, c, U, V = map(_c, (t1, t2, c, U, V))
        Y = _c(Y)
        squeeze = Y.ndim == 1
        if squeeze:
            Y = Y[:, None]
        N = t1.shape[0]
        M, K = Y.shape
        J = c.shape[0]
        Z = np.empty((N, K))
        getattr(_get_lib(), name)(N, M, J, K, t1, t2, c, U, V, Y, Z)
        return Z[:, 0] if squeeze else Z

    def general_matmul_lower(self, t1, t2, c, U, V, Y):
        return self._general(
            "celerite2_general_matmul_lower", t1, t2, c, U, V, Y
        )

    def general_matmul_upper(self, t1, t2, c, U, V, Y):
        return self._general(
            "celerite2_general_matmul_upper", t1, t2, c, U, V, Y
        )

    def get_celerite_matrices(self, ar, cr, ac, bc, cc, dc, x, diag):
        ar, cr, ac, bc, cc, dc, x, diag = map(
            _c, (ar, cr, ac, bc, cc, dc, x, diag)
        )
        N = x.shape[0]
        Jr, Jc = ar.shape[0], ac.shape[0]
        J = Jr + 2 * Jc
        c = np.empty(J)
        a = np.empty(N)
        U = np.empty((N, J))
        V = np.empty((N, J))
        _get_lib().celerite2_matrices(
            N, Jr, Jc, ar, cr, ac, bc, cc, dc, x, diag, c, a, U, V
        )
        return c, a, U, V


driver = _Driver()
