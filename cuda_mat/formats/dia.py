"""DIA (diagonal / banded) sparse layout — the no-gather SpMV format.

For banded matrices (all of the reference's large fixtures: mat900 and
mat10000 are finite-difference Laplacians with offsets {0, ±1, ±w}, reference
mat900.mtx:1-7 / mat10000.mtx:1-5), SpMV becomes a handful of elementwise
multiply-adds against *shifted* views of x — no gather at all, a streaming
loop at memory bandwidth (:class:`cuda_mat.ops.operators.DIAOperator`).

Storage is row-aligned: ``data[d, i] = A[i, i + offsets[d]]`` (0 where out of
range), so ``y = sum_d data[d] * shift(x, offsets[d])``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DIAMatrix:
    n: int
    m: int
    offsets: np.ndarray  # int32[ndiag], sorted ascending
    data: np.ndarray     # [ndiag, n] row-aligned diagonal values
    nnz: int             # true nnz

    @property
    def ndiag(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def bandwidth(self) -> int:
        return int(max(abs(int(self.offsets[0])), abs(int(self.offsets[-1])))) \
            if self.ndiag else 0

    @classmethod
    def from_csr(cls, csr, max_diags: int | None = None) -> "DIAMatrix":
        coo = csr.to_coo()
        offs = coo.cols.astype(np.int64) - coo.rows.astype(np.int64)
        uniq = np.unique(offs)
        if max_diags is not None and uniq.shape[0] > max_diags:
            raise ValueError(
                f"matrix has {uniq.shape[0]} distinct diagonals > max_diags={max_diags};"
                " DIA would be wasteful — use ELL/CSR instead")
        data = np.zeros((uniq.shape[0], csr.n), dtype=csr.data.dtype)
        dpos = np.searchsorted(uniq, offs)
        data[dpos, coo.rows] = coo.data
        return cls(csr.n, csr.m, uniq.astype(np.int32), data, csr.nnz)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        y = np.zeros(self.n, dtype=np.result_type(self.data, x))
        for d in range(self.ndiag):
            off = int(self.offsets[d])
            lo = max(0, -off)
            hi = min(self.n, self.m - off)
            if hi > lo:
                y[lo:hi] += self.data[d, lo:hi] * x[lo + off:hi + off]
        return y

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.m), dtype=self.data.dtype)
        for d in range(self.ndiag):
            off = int(self.offsets[d])
            lo = max(0, -off)
            hi = min(self.n, self.m - off)
            for i in range(lo, hi):
                out[i, i + off] = self.data[d, i]
        return out

    def density(self) -> float:
        """Fraction of stored DIA slots that are true nonzeros."""
        total = self.ndiag * self.n
        return self.nnz / total if total else 1.0
