"""Matrix Market (.mtx) reader/writer and the MM → CSR ingestion path.

Pure-Python equivalent of the reference's NIST ``mmio.c``/``mmio.h`` low-level
reader (banner parse at reference mmio.c:102, size at :195, COO data at :271)
plus the ``loadMMSparseMatrix`` conversion pipeline of reference
mmio_wrapper.h:133-348: read COO → reject unsupported types → symmetrize →
row-major sort → base normalization → CSR compression → pattern verification.

A fast native (C++) parser is used automatically for large files when the
``cuda_mat.native`` extension is built; this module is the always-available
fallback and the semantics oracle.
"""

from __future__ import annotations

import dataclasses
import io as _io
from typing import Tuple

import numpy as np

from cuda_mat.formats.coo import COOMatrix
from cuda_mat.formats.csr import CSRMatrix


@dataclasses.dataclass(frozen=True)
class MMBanner:
    """Parsed ``%%MatrixMarket`` banner (reference mmio.h:34-52 typecode)."""

    object: str      # "matrix"
    format: str      # "coordinate" | "array"
    field: str       # "real" | "integer" | "complex" | "pattern"
    symmetry: str    # "general" | "symmetric" | "skew-symmetric" | "hermitian"


def _parse_banner(line: str) -> MMBanner:
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise ValueError(f"not a Matrix Market file (bad banner: {line!r})")
    obj, fmt, field, sym = (p.lower() for p in parts[1:])
    if obj != "matrix":
        raise ValueError(f"unsupported MM object {obj!r}")
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unsupported MM format {fmt!r}")
    if field not in ("real", "integer", "complex", "pattern"):
        raise ValueError(f"unsupported MM field {field!r}")
    if sym not in ("general", "symmetric", "skew-symmetric", "hermitian"):
        raise ValueError(f"unsupported MM symmetry {sym!r}")
    return MMBanner(obj, fmt, field, sym)


def read_mm(path_or_file) -> Tuple[MMBanner, COOMatrix]:
    """Read a Matrix Market coordinate file into a base-0 COO matrix.

    No symmetrization is applied here — the banner is returned so callers can
    decide (the ingestion pipeline in :func:`load_mm_sparse_matrix` applies it,
    matching reference mmio_wrapper.h:172-230).
    """
    if hasattr(path_or_file, "read"):
        f = path_or_file
        close = False
    else:
        f = open(path_or_file, "r")
        close = True
    try:
        banner = _parse_banner(f.readline())
        if banner.format != "coordinate":
            # reference rejects array (dense) files (mmio_wrapper.h:166-169)
            raise ValueError("dense ('array') Matrix Market files are not supported")
        if banner.field in ("pattern", "complex"):
            # reference rejects pattern/complex for the 'd' loader
            # (mmio_wrapper.h:166-169)
            raise ValueError(f"MM field {banner.field!r} is not supported")
        # skip comments/blank lines, then the size line
        line = f.readline()
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline()
        n, m, nnz = (int(t) for t in line.split())
        body = f.read()
        vals = np.array(body.split(), dtype=np.float64)
        if vals.shape[0] != 3 * nnz:
            raise ValueError(
                f"expected {3 * nnz} tokens in MM body, got {vals.shape[0]}")
        vals = vals.reshape(nnz, 3)
        rows = vals[:, 0].astype(np.int64) - 1  # MM files are 1-based
        cols = vals[:, 1].astype(np.int64) - 1
        data = vals[:, 2]
        if rows.min(initial=0) < 0 or cols.min(initial=0) < 0:
            raise ValueError("index underflow: MM indices must be >= 1")
        return banner, COOMatrix(n, m, rows, cols, data)
    finally:
        if close:
            f.close()


def load_mm_sparse_matrix(path, symmetrize: bool = True,
                          prefer_native: bool = True) -> CSRMatrix:
    """Full ingestion: ``.mtx`` file → verified base-0 CSR.

    Equivalent of reference ``loadMMSparseMatrix`` (mmio_wrapper.h:133-348):
    symmetric/hermitian/skew files are expanded by mirroring off-diagonal
    entries (skew mirrors negated), entries are sorted row-major, and the CSR
    pattern is verified.  E.g. mat900.mtx's stored nnz 4322 becomes 7744 after
    symmetrization (reference mat900.mtx:7).
    """
    if prefer_native:
        try:
            from cuda_mat.native import loader as _native_loader

            if _native_loader.available():
                return _native_loader.load_mm_sparse_matrix(
                    str(path), symmetrize=symmetrize)
        except ImportError:
            pass
    banner, coo = read_mm(path)
    if symmetrize and banner.symmetry in ("symmetric", "hermitian",
                                          "skew-symmetric"):
        coo = coo.symmetrized(
            "skew-symmetric" if banner.symmetry == "skew-symmetric"
            else "symmetric")
    return CSRMatrix.from_coo(coo)


def write_mm(path_or_file, matrix, symmetry: str = "general",
             comment: str = "") -> None:
    """Write a CSR/COO matrix as a 1-based Matrix Market coordinate file
    (reference writers: mmio.c:392-405)."""
    coo = matrix.to_coo() if isinstance(matrix, CSRMatrix) else matrix
    if hasattr(path_or_file, "write"):
        f = path_or_file
        close = False
    else:
        f = open(path_or_file, "w")
        close = True
    try:
        f.write(f"%%MatrixMarket matrix coordinate real {symmetry}\n")
        for line in comment.splitlines():
            f.write(f"% {line}\n")
        f.write(f"{coo.n} {coo.m} {coo.nnz}\n")
        for r, c, v in zip(coo.rows, coo.cols, coo.data):
            f.write(f"{int(r) + 1} {int(c) + 1} {v:.16e}\n")
    finally:
        if close:
            f.close()


def write_mm_dense_vector(path_or_file, v: np.ndarray) -> None:
    """Write a dense vector as an n×1 sparse MM file (vec3.mtx style)."""
    v = np.asarray(v)
    idx = np.arange(v.shape[0])
    coo = COOMatrix(v.shape[0], 1, idx, np.zeros_like(idx), v)
    write_mm(path_or_file, coo)
