"""Row partitioning of banded (DIA) matrices with halo metadata.

Each of the ``ndev`` shards owns a contiguous block of ``s = npad/ndev`` rows
of the matrix, its slice of x/b, and needs a *halo* of the ``w`` neighboring
x entries on each side (``w`` = bandwidth).  The banded fixtures make halos
narrow (mat10000: w=100; the 1M-row config: w=100 ≪ s), so the exchange is a
neighbor ``ppermute`` of w-element edge segments — the cheapest possible
communication pattern (SURVEY §2 distributed components 1-2).

Padding strategy: the matrix is padded to ``npad`` rows with *identity rows*
(diag 1, off-diagonals 0) and b/x0 padded with zeros, so padded entries stay
exactly zero through every solver iteration and perturb no dot product.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from cuda_mat.formats.csr import CSRMatrix
from cuda_mat.formats.dia import DIAMatrix


@dataclasses.dataclass
class RowPartitionedBanded:
    """Host-side partition plan + padded DIA data for ``ndev`` row shards."""

    n: int                 # true dimension
    npad: int              # padded dimension (ndev * shard_rows)
    ndev: int
    shard_rows: int        # rows per shard
    halo: int              # bandwidth w
    offsets: Tuple[int, ...]
    data: np.ndarray       # [ndiag, npad] row-aligned, padded rows = identity

    @classmethod
    def from_matrix(cls, a, ndev: int, align: int = 1, max_diags: int = 128
                    ) -> "RowPartitionedBanded":
        """``align``: round shard_rows up to a multiple (a restrided factor
        shares a stencil partition's shard boundaries this way).
        ``max_diags`` bounds the DIA conversion so an unstructured matrix
        raises ValueError (→ the caller's ELL/all-gather fallback) *before*
        materializing an [ndiag, n] array."""
        dia = a.to_dia(max_diags=max_diags) if isinstance(a, CSRMatrix) else a
        if not isinstance(dia, DIAMatrix):
            # ValueError (not assert) so the auto-engine fallback in
            # dist_bicgstab — which catches only ValueError — still fires
            # under python -O
            raise ValueError(
                f"RowPartitionedBanded needs a CSR or DIA matrix, got"
                f" {type(a).__name__}")
        n = dia.n
        shard_rows = -(-n // ndev)
        shard_rows = -(-shard_rows // align) * align
        npad = shard_rows * ndev
        w = dia.bandwidth
        if w > shard_rows:
            raise ValueError(
                f"bandwidth {w} exceeds shard size {shard_rows}: neighbor-only"
                f" halo exchange impossible with {ndev} shards")
        offsets = tuple(int(o) for o in dia.offsets)
        if 0 not in offsets:
            offsets = tuple(sorted(offsets + (0,)))
        data = np.zeros((len(offsets), npad), dtype=dia.data.dtype)
        for k, off in enumerate(offsets):
            if off in list(dia.offsets):
                d = list(dia.offsets).index(off)
                data[k, :n] = dia.data[d]
            if off == 0:
                data[k, n:] = 1.0  # identity padding rows
        return cls(n, npad, ndev, shard_rows, w, offsets, data)

    def pad_vector(self, v: np.ndarray) -> np.ndarray:
        out = np.zeros(self.npad, dtype=v.dtype)
        out[: self.n] = v
        return out

    def unpad_vector(self, v: np.ndarray) -> np.ndarray:
        return np.asarray(v)[: self.n]

    def local_nnz(self) -> int:
        return int(np.count_nonzero(self.data))


@dataclasses.dataclass
class RowPartitionedStencil:
    """Row partition of a constant-coefficient grid stencil in the
    gap-strided layout of
    :class:`~cuda_mat.ops.stencil.ConstStencilOperator`.

    The matrix-free matvec row-partitions naturally: each shard owns whole
    grid rows (``shard_rows`` is a multiple of the stride, so every shard
    sees the same gap pattern), the halo is the ``max |strided offset|``
    (≲ one grid row per side), and there is no per-shard array state at
    all — the coefficients are compile-time scalars.  Replaces the same
    hot-loop call sites as the distributed DIA path (reference
    pbicgstab.cu:104,132).

    Padding semantics: grid rows ``[rows, npad/stride)`` that round the
    partition up are zero, and the local matvec masks them (by global grid
    row), so they stay an exact fixed point of the iteration.
    """

    n: int                  # true dimension R*C
    c_grid: int             # grid row length C
    stride: int             # strided row length S = C + gap
    np_true: int            # R*S — global strided length
    npad: int               # ndev * shard_rows
    ndev: int
    shard_rows: int         # strided entries per shard (multiple of stride)
    halo: int               # max |strided offset|
    terms: Tuple[Tuple[int, int, float], ...]   # true-coord (off, dc, scal)
    strided_terms: Tuple[Tuple[int, float], ...]  # (off', scal)

    @property
    def rows(self) -> int:
        """Grid rows R of the true problem."""
        return self.n // self.c_grid

    @classmethod
    def from_matrix(cls, a, ndev: int, max_diags: int = 128, gap: int = 0
                    ) -> "RowPartitionedStencil":
        from cuda_mat.ops.stencil import detect_const_stencil, stencil_layout

        dia = a.to_dia(max_diags=max_diags) if isinstance(a, CSRMatrix) else a
        if not isinstance(dia, DIAMatrix):
            # ValueError (not assert): see RowPartitionedBanded.from_matrix
            raise ValueError(
                f"RowPartitionedStencil needs a CSR or DIA matrix, got"
                f" {type(a).__name__}")
        det = detect_const_stencil(dia)
        if det is None:
            raise ValueError(
                "matrix is not a constant-coefficient grid stencil; use"
                " RowPartitionedBanded / RowPartitionedELL instead")
        c_grid, terms = det
        stride, np_true, sterms = stencil_layout(c_grid, dia.n, terms, gap)
        shard_rows = -(-(dia.n // c_grid) // ndev) * stride
        w = max(abs(t[0]) for t in sterms)
        if w > shard_rows:
            raise ValueError(
                f"strided halo {w} exceeds shard size {shard_rows}: neighbor"
                f"-only halo exchange impossible with {ndev} shards")
        return cls(dia.n, c_grid, stride, np_true, shard_rows * ndev, ndev,
                   shard_rows, w, terms, sterms)

    def strided_scatter(self, v: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Scatter a true-coordinate vector into the padded strided layout
        with ``fill`` in gap/tail cells."""
        g = np.full((self.rows, self.stride), fill, dtype=v.dtype)
        g[:, : self.c_grid] = np.asarray(v).reshape(self.rows, self.c_grid)
        out = np.full(self.npad, fill, dtype=v.dtype)
        out[: self.np_true] = g.reshape(-1)
        return out

    def pad_vector(self, v: np.ndarray) -> np.ndarray:
        return self.strided_scatter(np.asarray(v))

    def unpad_vector(self, v: np.ndarray) -> np.ndarray:
        g = np.asarray(v)[: self.np_true].reshape(self.rows, self.stride)
        return g[:, : self.c_grid].reshape(-1)


@dataclasses.dataclass
class RowPartitionedELL:
    """Row partition of a *general* sparse matrix in ELL layout.

    For matrices whose column footprint is not a narrow band, neighbor halo
    exchange does not apply; the distributed SpMV instead all-gathers x over
    the mesh (SURVEY §5 "ppermute/all-gather" — this is the all-gather side).
    Padded rows are identity (diag 1) so padding stays a fixed point.
    """

    n: int
    npad: int
    ndev: int
    shard_rows: int
    values: np.ndarray   # [npad, K]
    cols: np.ndarray     # int32[npad, K]
    diag: np.ndarray     # [npad] (1.0 on padded rows)

    @classmethod
    def from_matrix(cls, csr: CSRMatrix, ndev: int) -> "RowPartitionedELL":
        n = csr.n
        shard_rows = -(-n // ndev)
        npad = shard_rows * ndev
        ell = csr.to_ell()
        k = ell.k
        values = np.zeros((npad, k), dtype=ell.values.dtype)
        cols = np.zeros((npad, k), dtype=np.int32)
        values[:n] = ell.values
        cols[:n] = ell.cols
        pad_rows = np.arange(n, npad)
        cols[n:] = pad_rows[:, None]
        values[n:, 0] = 1.0
        diag = np.ones(npad, dtype=values.dtype)
        diag[:n] = csr.diagonal()
        return cls(n, npad, ndev, shard_rows, values, cols, diag)

    def pad_vector(self, v: np.ndarray) -> np.ndarray:
        out = np.zeros(self.npad, dtype=v.dtype)
        out[: self.n] = v
        return out

    def unpad_vector(self, v: np.ndarray) -> np.ndarray:
        return np.asarray(v)[: self.n]
