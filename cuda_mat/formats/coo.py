"""COO (coordinate) sparse matrix — the on-disk Matrix Market layout."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format sparse matrix with base-0 indices.

    Mirrors what the reference's Matrix Market reader produces before CSR
    compression (reference mmio.c:271-337 reads (row, col, val) triplets;
    reference mmio_wrapper.h:251-258 sorts them row-major).
    """

    n: int  # rows
    m: int  # cols
    rows: np.ndarray  # int32[nnz]
    cols: np.ndarray  # int32[nnz]
    data: np.ndarray  # float64[nnz]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def __post_init__(self):
        self.rows = np.asarray(self.rows, dtype=np.int32)
        self.cols = np.asarray(self.cols, dtype=np.int32)
        self.data = np.asarray(self.data)
        if not (self.rows.shape == self.cols.shape == self.data.shape):
            raise ValueError("COO triplet arrays must have equal length")

    def sorted_row_major(self) -> "COOMatrix":
        """Stable sort entries by (row, col) — the CSR pre-pass
        (reference mmio_wrapper.h:253 qsorts row-major)."""
        order = np.lexsort((self.cols, self.rows))
        return COOMatrix(self.n, self.m, self.rows[order], self.cols[order],
                         self.data[order])

    def symmetrized(self, kind: str = "symmetric") -> "COOMatrix":
        """Mirror off-diagonal entries for MM symmetric/hermitian/skew files.

        Matches reference mmio_wrapper.h:172-230: every stored strictly
        off-diagonal entry (i, j) gains a mirror (j, i); skew-symmetric mirrors
        are negated (reference mmio_wrapper.h:205-206).
        """
        off = self.rows != self.cols
        mrows, mcols = self.cols[off], self.rows[off]
        mdata = self.data[off]
        if kind == "skew-symmetric":
            mdata = -mdata
        return COOMatrix(
            self.n,
            self.m,
            np.concatenate([self.rows, mrows]),
            np.concatenate([self.cols, mcols]),
            np.concatenate([self.data, mdata]),
        )

    def to_csr(self, sum_duplicates: bool = False):
        from cuda_mat.formats.csr import CSRMatrix

        return CSRMatrix.from_coo(self, sum_duplicates=sum_duplicates)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.m), dtype=self.data.dtype)
        np.add.at(out, (self.rows, self.cols), self.data)
        return out
