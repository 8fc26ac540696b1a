"""CSR (compressed sparse row) — the canonical compute format.

The reference's entire solver API consumes CSR triplets ``(A, iA, jA)``
(reference pbicgstab.h:96-110); its loader builds them via row-major sort +
index compression (reference mmio_wrapper.h:24-46) and validates them with
``verify_pattern`` (reference mmio_wrapper.h:91-130).  This module provides
the same capabilities on numpy arrays, always base-0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


def verify_pattern(n: int, nnz: int, indptr: np.ndarray, indices: np.ndarray,
                   strict_sorted_cols: bool = True,
                   m: Optional[int] = None) -> None:
    """Validate CSR invariants; raise ValueError on violation.

    Port of the checks in reference mmio_wrapper.h:91-130: nnz consistency,
    monotone non-decreasing row pointer, column indices in range and sorted
    (strictly increasing, which also forbids duplicates) within each row.
    ``m`` is the column count (defaults to ``n`` for square matrices).
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    if m is None:
        m = n
    if indptr.shape[0] != n + 1:
        raise ValueError(f"indptr must have length n+1={n + 1}, got {indptr.shape[0]}")
    if indptr[0] != 0:
        raise ValueError(f"base-0 CSR requires indptr[0]==0, got {indptr[0]}")
    if indptr[-1] != nnz:
        raise ValueError(f"indptr[-1]={indptr[-1]} != nnz={nnz}")
    if np.any(np.diff(indptr) < 0):
        raise ValueError("indptr must be non-decreasing")
    if nnz and (indices.min() < 0 or indices.max() >= max(1, m)):
        raise ValueError(
            f"column index out of range [0, {m}): min={indices.min()},"
            f" max={indices.max()}")
    row_len = np.diff(indptr)
    if strict_sorted_cols and nnz:
        # strictly increasing columns within each row
        d = np.diff(indices)
        # positions where a new row starts (first element of each row) are exempt
        starts = np.zeros(nnz, dtype=bool)
        starts[indptr[:-1][row_len > 0]] = True
        bad = (d <= 0) & ~starts[1:]
        if np.any(bad):
            k = int(np.argmax(bad))
            raise ValueError(
                f"columns not strictly increasing within a row at nnz index {k + 1}")


@dataclasses.dataclass
class CSRMatrix:
    """Base-0 CSR matrix over numpy arrays.

    ``data`` float64 by default, ``indices``/``indptr`` int32 (matching the
    reference's ``int`` index type, reference pbicgstab.h:100-103).
    """

    n: int
    m: int
    data: np.ndarray     # [nnz]
    indices: np.ndarray  # int32[nnz] column indices
    indptr: np.ndarray   # int32[n+1]

    def __post_init__(self):
        self.data = np.asarray(self.data)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        self.indptr = np.asarray(self.indptr, dtype=np.int32)

    # -- construction -----------------------------------------------------

    @classmethod
    def from_coo(cls, coo, sum_duplicates: bool = False) -> "CSRMatrix":
        coo = coo.sorted_row_major()
        rows, cols, data = coo.rows, coo.cols, coo.data
        if sum_duplicates and coo.nnz:
            key = rows.astype(np.int64) * coo.m + cols
            uniq, inv = np.unique(key, return_inverse=True)
            newdata = np.zeros(uniq.shape[0], dtype=data.dtype)
            np.add.at(newdata, inv, data)
            rows = (uniq // coo.m).astype(np.int32)
            cols = (uniq % coo.m).astype(np.int32)
            data = newdata
        indptr = np.zeros(coo.n + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        out = cls(coo.n, coo.m, data, cols, indptr.astype(np.int32))
        out.verify()
        return out

    @classmethod
    def from_dense(cls, a: np.ndarray, eps: float = 0.0) -> "CSRMatrix":
        a = np.asarray(a)
        mask = np.abs(a) > eps
        rows, cols = np.nonzero(mask)
        from cuda_mat.formats.coo import COOMatrix

        return cls.from_coo(COOMatrix(a.shape[0], a.shape[1], rows, cols, a[mask]))

    @classmethod
    def from_fn(cls, n: int, m: int, f: Callable[[int, int], float],
                eps: float = 0.0) -> "CSRMatrix":
        """Build a CSR matrix from an element function with an |el|>eps cutoff.

        Equivalent of the reference's ``fill_csr_matrix`` template
        (reference pbicgstab.h:57-76), which the CLI uses to generate random
        diagonally-nonzero systems (reference example.cpp:274-286).
        """
        data, indices, indptr = [], [], [0]
        for i in range(n):
            for j in range(m):
                el = f(i, j)
                if abs(el) > eps:
                    data.append(el)
                    indices.append(j)
            indptr.append(len(data))
        return cls(n, m, np.array(data, dtype=np.float64),
                   np.array(indices, dtype=np.int32),
                   np.array(indptr, dtype=np.int32))

    # -- queries ----------------------------------------------------------

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def verify(self) -> None:
        verify_pattern(self.n, self.nnz, self.indptr, self.indices, m=self.m)

    def diagonal(self) -> np.ndarray:
        """Dense main diagonal (zeros where not stored)."""
        d = np.zeros(min(self.n, self.m), dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.n), self.row_lengths)
        on = self.indices == rows
        d[rows[on]] = self.data[on]
        return d

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host (numpy) SpMV — the oracle for device kernels."""
        y = np.zeros(self.n, dtype=np.result_type(self.data, x))
        np.add.at(y, np.repeat(np.arange(self.n), self.row_lengths),
                  self.data * x[self.indices])
        return y

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.m), dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.n), self.row_lengths)
        out[rows, self.indices] = self.data
        return out

    def to_coo(self):
        from cuda_mat.formats.coo import COOMatrix

        rows = np.repeat(np.arange(self.n, dtype=np.int32), self.row_lengths)
        return COOMatrix(self.n, self.m, rows, self.indices.copy(), self.data.copy())

    def to_ell(self, pad_col: Optional[int] = None):
        from cuda_mat.formats.ell import ELLMatrix

        return ELLMatrix.from_csr(self, pad_col=pad_col)

    def to_dia(self, max_diags: Optional[int] = None):
        from cuda_mat.formats.dia import DIAMatrix

        return DIAMatrix.from_csr(self, max_diags=max_diags)

    def to_bsr(self, block: int = 2):
        from cuda_mat.formats.bsr import BSRMatrix

        return BSRMatrix.from_csr(self, block)

    def transpose(self) -> "CSRMatrix":
        """CSR transpose (counting sort by column), the numpy equivalent of the
        OMP reference's ``Transpose2`` (reference bicstab_omp/bicstab.cpp:35-66
        — which has an int-truncation bug on values we do not reproduce)."""
        coo = self.to_coo()
        from cuda_mat.formats.coo import COOMatrix

        return CSRMatrix.from_coo(
            COOMatrix(self.m, self.n, coo.cols, coo.rows, coo.data))

    def split_diag(self):
        """Split ``A = A0 + diag(d)``: return (A0 with the stored main-diagonal
        entries removed, dense d).  Inverse of the mat3_A0/vec3_d fixture pair
        (reference mat3_A0.mtx, vec3_d.mtx)."""
        coo = self.to_coo()
        on = coo.rows == coo.cols
        d = np.zeros(min(self.n, self.m), dtype=self.data.dtype)
        np.add.at(d, coo.rows[on], coo.data[on])
        from cuda_mat.formats.coo import COOMatrix

        a0 = CSRMatrix.from_coo(COOMatrix(
            self.n, self.m, coo.rows[~on], coo.cols[~on], coo.data[~on]))
        return a0, d
