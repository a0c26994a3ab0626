"""ctypes bindings for the native (C++) dense restart kernels.

The shared library is built from the package's own copy of the C++ core,
`dense/arnoldi_dense.cpp` (the same source and g++ command as the JAX
package's binding), into the build directory of `_build.py` at first use.  It implements the same
LAPACK-free kernels as the numpy modules in this package; the numpy layer is
the tested behavioral reference, the native layer the fast path for the
host-side restart work.  `available()` builds and loads the library on its
first call and reports whether that worked; with ARNOLDI_TPU_NATIVE=0 it is
never loaded and the driver runs the numpy layer (identical semantics, a
host layer either way).  `History.dense_layer` records which one a solve ran.

All wrappers operate in place on C-contiguous float64/complex128 arrays
with the same conventions as the numpy layer (0-based, half-open windows).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .._build import PACKAGE_DIR, build_shared

_SRC_PATH = PACKAGE_DIR / "dense" / "arnoldi_dense.cpp"
_COMMAND = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_tried = False
# Why the library is not loaded (None while it is, or before the first try).
build_error = None

_c_long = ctypes.c_long
_c_int = ctypes.c_int
_c_double = ctypes.c_double
_p = ctypes.c_void_p


def _load():
    lib = ctypes.CDLL(str(build_shared("arnoldi_dense", [_SRC_PATH], _COMMAND)[0]))
    lib.am_local_schur_d.restype = _c_int
    lib.am_local_schur_d.argtypes = [_p, _c_long, _c_long, _c_long, _c_long,
                                     _c_long, _p, _c_long, _c_long, _c_double,
                                     _c_long]
    lib.am_local_schur_z.restype = _c_int
    lib.am_local_schur_z.argtypes = lib.am_local_schur_d.argtypes
    lib.am_partition_d.argtypes = [_p, _c_long, _c_long, _p, _c_long, _c_long, _p]
    lib.am_partition_z.argtypes = lib.am_partition_d.argtypes
    lib.am_sort_schur_d.argtypes = [_p, _c_long, _c_long, _p, _c_long, _c_long,
                                    _c_long, _c_int]
    lib.am_sort_schur_z.argtypes = lib.am_sort_schur_d.argtypes
    lib.am_restore_d.argtypes = [_p, _c_long, _c_long, _c_long, _p, _c_long,
                                 _c_long, _c_long, _c_long]
    lib.am_restore_z.argtypes = lib.am_restore_d.argtypes
    lib.am_eigvals_d.argtypes = [_p, _c_long, _c_long, _c_long, _c_double, _p, _p]
    lib.am_eigvals_z.argtypes = lib.am_eigvals_d.argtypes
    lib.am_residuals_d.argtypes = [_p, _c_long, _c_long, _p, _c_long,
                                   _c_double, _c_long, _c_long, _p]
    lib.am_residuals_z.argtypes = [_p, _c_long, _c_long, _p, _c_long,
                                   _p, _c_long, _c_long, _p]
    return lib


# Ordering codes shared with the C++ side.
ORDER_CODES = {"LM": 0, "LR": 1, "SR": 2, "LI": 3, "SI": 4}

# The C++ kernels use fixed stack buffers of this size for eigenvector /
# eigenvalue scratch.
MAX_DIM = 512


def available():
    """Build (once) and load the library; True when it is usable."""
    global _lib, _tried, build_error
    if not _tried:
        _tried = True
        if os.environ.get("ARNOLDI_TPU_NATIVE", "1") == "0":
            build_error = "disabled by ARNOLDI_TPU_NATIVE=0"
        else:
            try:
                _lib = _load()
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                build_error = f"{type(exc).__name__}: {exc}"
    return _lib is not None


def _library():
    if not available():
        raise RuntimeError(f"the native dense core is not loaded: {build_error}")
    return _lib


def _is_c(a):
    return a.flags["C_CONTIGUOUS"]


def _ptr(a):
    return a.ctypes.data_as(_p)


def _complex(H):
    return np.iscomplexobj(H)


def local_schur(H, lo, hi, Q=None, tol=None, maxiter=None):
    """Native drop-in for dense.schur.local_schur (in place)."""
    assert _is_c(H) and (Q is None or _is_c(Q))
    if tol is None:
        tol = float(np.finfo(H.real.dtype).eps)
    if maxiter is None:
        maxiter = 100 * H.shape[0]
    m_rows, n = H.shape
    qld = Q.shape[1] if Q is not None else 0
    qrows = Q.shape[0] if Q is not None else 0
    fn = _library().am_local_schur_z if _complex(H) else _library().am_local_schur_d
    ok = fn(_ptr(H), H.shape[1], m_rows, n, lo, hi,
            _ptr(Q) if Q is not None else None, qld, qrows, tol, maxiter)
    if not ok and not _complex(H):
        raise RuntimeError("QR algorithm did not converge")
    return bool(ok)


def partition_three_way(R, Q, groups):
    assert _is_c(R) and _is_c(Q)
    g = np.ascontiguousarray(groups, dtype=np.int64)
    fn = _library().am_partition_z if _complex(R) else _library().am_partition_d
    fn(_ptr(R), R.shape[1], R.shape[1], _ptr(Q), Q.shape[1], Q.shape[0], _ptr(g))


def sort_schur(R, Q, count, which):
    assert _is_c(R) and _is_c(Q)
    code = ORDER_CODES[which]
    fn = _library().am_sort_schur_z if _complex(R) else _library().am_sort_schur_d
    fn(_ptr(R), R.shape[1], R.shape[1], _ptr(Q), Q.shape[1], Q.shape[0],
       count, code)


def restore_arnoldi(H, lo, hi, Q):
    assert _is_c(H) and _is_c(Q)
    rows, cols = H.shape
    fn = _library().am_restore_z if _complex(H) else _library().am_restore_d
    fn(_ptr(H), H.shape[1], rows, cols, _ptr(Q), Q.shape[1], Q.shape[0], lo, hi)


def copy_eigenvalues(lams, R, lo=0, hi=None, tol=None):
    assert _is_c(R)
    if hi is None:
        hi = R.shape[1]
    if tol is None:
        tol = float(np.finfo(R.real.dtype).eps)
    out_re = np.zeros(R.shape[1], dtype=np.float64)
    out_im = np.zeros(R.shape[1], dtype=np.float64)
    fn = _library().am_eigvals_z if _complex(R) else _library().am_eigvals_d
    fn(_ptr(R), R.shape[1], lo, hi, tol, _ptr(out_re), _ptr(out_im))
    lams[lo:hi] = out_re[lo:hi] + 1j * out_im[lo:hi]
    return lams


def copy_residuals(rs, H, Q, h_last, lo, hi):
    assert _is_c(H) and _is_c(Q)
    m = H.shape[1]
    if _complex(H):
        hl = np.array([h_last], dtype=np.complex128)
        _library().am_residuals_z(_ptr(H), H.shape[1], m, _ptr(Q), Q.shape[1],
                            _ptr(hl), lo, hi, _ptr(rs))
    else:
        _library().am_residuals_d(_ptr(H), H.shape[1], m, _ptr(Q), Q.shape[1],
                            float(h_last), lo, hi, _ptr(rs))
    return rs
