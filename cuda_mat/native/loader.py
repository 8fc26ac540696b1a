"""ctypes bindings for the native C++ components (with availability probe).

See ``mmio_fast.cpp`` for the implementation.  Until the shared library is
built, ``available()`` returns False and callers fall back to the pure-Python
paths.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "libcudamat_native.so")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is None and not _load_failed:
        if not os.path.exists(_LIB_PATH):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            _configure(lib)
            _lib = lib
        except (OSError, AttributeError):
            # AttributeError = a stale prebuilt .so missing a newer symbol
            # (e.g. cmt_milu0): treat exactly like an unbuilt library so
            # every caller falls back to the pure-Python paths instead of
            # crashing (rebuild with `make -C cuda_mat/native`)
            _load_failed = True
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    ll = ctypes.c_longlong
    lib.cmt_mm_open.restype = ctypes.c_int
    lib.cmt_mm_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ll), ctypes.POINTER(ll),
                                ctypes.POINTER(ll)]
    lib.cmt_mm_fill_csr.restype = None
    lib.cmt_mm_fill_csr.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p]
    lib.cmt_mm_close.restype = None
    lib.cmt_mm_close.argtypes = [ctypes.c_void_p]
    lib.cmt_ilu0.restype = ll
    lib.cmt_ilu0.argtypes = [ll, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.cmt_milu0.restype = ll
    lib.cmt_milu0.argtypes = [ll, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_double]


def available() -> bool:
    return _load() is not None


def load_mm_sparse_matrix(path: str, symmetrize: bool = True):
    """Fast path for .mtx ingestion.  Two-phase: query sizes, then fill
    caller-allocated numpy buffers (no ownership transfer across the FFI)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    from cuda_mat.formats.csr import CSRMatrix

    handle = ctypes.c_void_p()
    n = ctypes.c_longlong()
    m = ctypes.c_longlong()
    nnz = ctypes.c_longlong()
    rc = lib.cmt_mm_open(path.encode(), ctypes.c_int(1 if symmetrize else 0),
                         ctypes.byref(handle), ctypes.byref(n),
                         ctypes.byref(m), ctypes.byref(nnz))
    if rc != 0:
        raise ValueError(f"native MM parse failed for {path!r} (code {rc})")
    data = np.empty(nnz.value, dtype=np.float64)
    indices = np.empty(nnz.value, dtype=np.int32)
    indptr = np.empty(n.value + 1, dtype=np.int32)
    lib.cmt_mm_fill_csr(handle,
                        data.ctypes.data_as(ctypes.c_void_p),
                        indices.ctypes.data_as(ctypes.c_void_p),
                        indptr.ctypes.data_as(ctypes.c_void_p))
    lib.cmt_mm_close(handle)
    out = CSRMatrix(int(n.value), int(m.value), data, indices, indptr)
    out.verify()
    return out


def ilu0_factorize(csr) -> np.ndarray:
    """Native ILU(0) factorization (same semantics as
    cuda_mat.reference.cpu_solvers.ilu0_factorize)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    m = csr.data.astype(np.float64).copy()
    rc = lib.cmt_ilu0(ctypes.c_longlong(csr.n),
                      csr.indptr.ctypes.data_as(ctypes.c_void_p),
                      csr.indices.ctypes.data_as(ctypes.c_void_p),
                      m.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"native ILU(0) failed (zero/missing diagonal at row {rc - 1})")
    return m


def milu0_factorize(csr, omega: float) -> np.ndarray:
    """Native relaxed modified-ILU(0): ``omega`` times the dropped fill of
    each row is subtracted from its diagonal (omega=1 preserves A's row
    sums; omega=0 degenerates to plain ILU(0))."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    m = csr.data.astype(np.float64).copy()
    rc = lib.cmt_milu0(ctypes.c_longlong(csr.n),
                       csr.indptr.ctypes.data_as(ctypes.c_void_p),
                       csr.indices.ctypes.data_as(ctypes.c_void_p),
                       m.ctypes.data_as(ctypes.c_void_p),
                       ctypes.c_double(omega))
    if rc != 0:
        raise ValueError(
            f"native MILU(0) failed (zero/missing diagonal at row {rc - 1})")
    return m
