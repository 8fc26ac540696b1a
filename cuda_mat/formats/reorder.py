"""Bandwidth-reducing row/column reordering (reverse Cuthill–McKee).

The reference has no reordering; its banded fixtures are already optimally
ordered (mat10000.mtx is a banded Laplacian).  Here ordering is a
*performance feature*: a narrow bandwidth makes (a) the blocked trisolve /
distributed banded partition applicable and cheap (K and the halo grow with
the bandwidth), and (b) the SpMV block-compact — a band-w matrix has few
nonzero blocks per block-row, so ``format="bell"`` turns element gathers
into block products.  (The no-gather DIA operator additionally needs *few
distinct offsets*, which RCM does not guarantee.)

``rcm_permutation`` returns ``perm`` such that ``A[perm][:, perm]`` has
(heuristically) minimal bandwidth; solving the permuted system and scattering
the solution back is exact:

    (P A Pᵀ)(P x) = (P b)   ⟹   x = scatter(x_perm, perm)

Note: ILU(0) quality depends on the ordering, so a reordered solve may take a
different iteration count than the reference trajectory — reordering is
therefore opt-in (``SolverConfig.reorder`` / CLI ``--reorder``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _sym_adjacency(csr) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected adjacency (pattern of A + Aᵀ, no self loops) as
    (indptr, indices) with per-row neighbor lists sorted by degree."""
    rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    cols = csr.indices.astype(np.int64)
    mask = rows != cols
    u = np.concatenate([rows[mask], cols[mask]])
    v = np.concatenate([cols[mask], rows[mask]])
    # dedup (u, v) pairs
    key = u * csr.n + v
    uniq = np.unique(key)
    u = (uniq // csr.n).astype(np.int64)
    v = (uniq % csr.n).astype(np.int64)
    indptr = np.zeros(csr.n + 1, dtype=np.int64)
    np.add.at(indptr, u + 1, 1)
    indptr = np.cumsum(indptr)
    degree = np.diff(indptr)
    # neighbors are already grouped by u (uniq is sorted); sort each row's
    # neighbor list by degree (classic CM tie-break) via a stable argsort
    order = np.lexsort((degree[v], u))
    return indptr, v[order]


def rcm_permutation(csr) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of the symmetrized pattern of ``csr``.

    Returns ``perm`` (int64[n]) — new index ``k`` holds old row ``perm[k]``.
    Handles disconnected components (each seeded at its min-degree node).
    """
    n = csr.n
    indptr, nbrs = _sym_adjacency(csr)
    degree = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # seed order: global min-degree first (per component)
    seeds = np.argsort(degree, kind="stable")
    si = 0
    while pos < n:
        while si < len(seeds) and visited[seeds[si]]:
            si += 1
        start = seeds[si]
        visited[start] = True
        order[pos] = start
        pos += 1
        # BFS one level at a time, each level expansion fully vectorized
        # (a per-node python loop costs minutes at the 1M-row scales the
        # headline solves run in ~100 ms).  Candidate order = (parent
        # position, then degree — neighbor rows are pre-sorted by degree),
        # first occurrence wins: identical to the sequential queue algorithm.
        level = np.array([start], dtype=np.int64)
        while level.size:
            starts_ = indptr[level]
            counts = indptr[level + 1] - starts_
            total = int(counts.sum())
            if total == 0:
                break
            ends = np.cumsum(counts)
            # flat indices of each level node's neighbor list, concatenated
            flat = np.arange(total) + np.repeat(starts_ - (ends - counts),
                                                counts)
            cand = nbrs[flat]
            cand = cand[~visited[cand]]
            if cand.size == 0:
                break
            # order-preserving dedup (keep first occurrence)
            _, first = np.unique(cand, return_index=True)
            level = cand[np.sort(first)]
            visited[level] = True
            order[pos: pos + level.size] = level
            pos += level.size
    return order[::-1].copy()


def bandwidth(csr) -> int:
    """max |i - j| over the stored pattern (0 for diagonal/empty)."""
    if csr.nnz == 0:
        return 0
    rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    offs = csr.indices.astype(np.int64) - rows
    return int(max(-offs.min(), offs.max(), 0))


def permute_csr(csr, perm: np.ndarray):
    """Symmetric permutation ``P A Pᵀ``: row/col ``perm[k]`` becomes ``k``."""
    from cuda_mat.formats.coo import COOMatrix
    from cuda_mat.formats.csr import CSRMatrix

    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    coo = csr.to_coo()
    return CSRMatrix.from_coo(COOMatrix(csr.n, csr.m,
                                        inv[coo.rows].astype(np.int32),
                                        inv[coo.cols].astype(np.int32),
                                        coo.data.copy()))


def permute_vector(v: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """``(P v)[k] = v[perm[k]]``."""
    return np.asarray(v)[perm]


def unpermute_vector(v: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Inverse of :func:`permute_vector`."""
    out = np.empty_like(np.asarray(v))
    out[perm] = v
    return out
