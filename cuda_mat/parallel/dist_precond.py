"""Distributed block-Jacobi ILU(0) preconditioner.

The reference's ILU(0) triangular solves are global sequential recurrences —
they do not distribute.  The standard domain-decomposition answer is **block-Jacobi / additive Schwarz**: each row shard
factorizes its local diagonal block ``A_ss`` with ILU(0) and applies
``M⁻¹ = diag(M_0⁻¹ … M_{p-1}⁻¹)`` — zero communication per application, each
shard running its own blocked triangular solve
(:class:`cuda_mat.ops.trisolve.BlockTriangularSolver`).  Off-shard
couplings are simply dropped from M (not from A), which weakens the
preconditioner gracefully as the shard count grows — the classic
convergence/locality trade.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from cuda_mat.formats.coo import COOMatrix
from cuda_mat.formats.csr import CSRMatrix
from cuda_mat.ops.trisolve import BlockTriangularSolver, _block_setup_tri
from cuda_mat.parallel.partition import RowPartitionedBanded


def _local_block_csr(part: RowPartitionedBanded, shard: int) -> CSRMatrix:
    """CSR of shard s's diagonal block A_ss (local indices), extracted from
    the padded DIA data (padded rows are identity, so every row has a
    diagonal and ILU(0) is well-posed)."""
    sr = part.shard_rows
    lo = shard * sr
    rows, cols, vals = [], [], []
    for k, off in enumerate(part.offsets):
        seg = part.data[k, lo:lo + sr]
        r = np.arange(sr)
        c = r + off
        ok = (c >= 0) & (c < sr) & (seg != 0)
        rows.append(r[ok])
        cols.append(c[ok])
        vals.append(seg[ok])
    return CSRMatrix.from_coo(COOMatrix(
        sr, sr, np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals)))


def build_block_jacobi_ilu(part: RowPartitionedBanded, trisolve_block: int,
                           dtype, milu_omega: float = 0.0
                           ) -> Tuple[np.ndarray, ...]:
    """Per-shard ILU(0) + blocked-trisolve setup, stacked on a leading shard
    axis so shard_map can split it.

    Returns (w_lo, vals_lo, cols_lo, w_up, vals_up, cols_up) with shapes
    ``(ndev, nb, B, B)`` / ``(ndev, nb, B, K)`` — K padded to the max across
    shards.  ``milu_omega``: relaxed modified-ILU(0) factor values per shard
    (see :func:`cuda_mat.precond.preconditioners.milu0_factorize`).
    """
    from cuda_mat.precond.preconditioners import _factorize

    per_shard = []
    for s in range(part.ndev):
        local = _local_block_csr(part, s)
        mvals = _factorize(local, milu_omega)
        lo = _block_setup_tri(local, mvals, trisolve_block, lower=True)
        up = _block_setup_tri(local, mvals, trisolve_block, lower=False)
        per_shard.append((lo, up))

    def stack(idx_tri, idx_arr, pad_k=False):
        arrs = [ps[idx_tri][idx_arr] for ps in per_shard]
        if pad_k:
            kmax = max(a.shape[-1] for a in arrs)
            arrs = [np.pad(a, ((0, 0), (0, 0), (0, kmax - a.shape[-1])))
                    for a in arrs]
        return np.stack(arrs).astype(
            np.int32 if arrs[0].dtype.kind == "i" else np.dtype(dtype))

    return (stack(0, 0), stack(0, 1, True), stack(0, 2, True),
            stack(1, 0), stack(1, 1, True), stack(1, 2, True))


def local_solver_from_stacked(w_lo, vals_lo, cols_lo, w_up, vals_up, cols_up,
                              shard_rows: int, trisolve_block: int
                              ) -> BlockTriangularSolver:
    """Inside shard_map: wrap this shard's (1, ...) slices into a local
    BlockTriangularSolver."""
    return BlockTriangularSolver(
        w_lo[0], vals_lo[0], cols_lo[0], w_up[0], vals_up[0], cols_up[0],
        n=shard_rows, block=trisolve_block)
