"""Blocked sparse triangular solves — the device ``csrsv_solve``.

The reference applies its ILU(0) preconditioner with cuSPARSE's level-scheduled
triangular solves (analysis at reference pbicgstab.cu:338-345, solves at
:92-98,:121-127).  Level scheduling is useless on the reference's own banded
fixtures: for a band {-1, -w} lower factor, level(i) = i — fully sequential.

This design instead *blocks the recurrence*: partition rows into
``nb`` blocks of size B.  Within a block, the dependency is a dense B×B unit
triangular system whose inverse ``W_b`` is precomputed once at setup; across
blocks, each row depends on earlier rows only through its off-block entries,
stored as a per-block ELL gather.  The solve becomes a ``fori_loop`` of
``nb`` steps, each one rectangular gather + one (B,K) contraction + one
(B,B)·(B,) matrix-vector product:

    y_b = W_b @ (f_b − Σ_k vals[b,:,k] · y[cols[b,:,k]])

This is exact (up to fp rounding in the precomputed inverse), turns the
latency-bound recurrence into nb dense products, and costs O(n·B) memory — pick B ≥
the lower bandwidth to keep K small (mat10000: w=100 → K ≤ 2 with B=128).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _block_setup_tri(csr, mvals: np.ndarray, block: int, lower: bool):
    """Host-side extraction of one triangle of the combined ILU factor.

    For ``lower``: strict lower triangle with implied unit diagonal
    (reference DIAG_TYPE_UNIT, pbicgstab.cu:93).  For upper: diagonal + strict
    upper (DIAG_TYPE_NON_UNIT, :97).  Returns (W, vals, cols) where W is the
    per-block inverse of the diagonal block and vals/cols the off-block ELL
    (each row's off-block entries in CSR order).  Vectorized over all nnz: a
    10M-row factor sets up in seconds.
    """
    n = csr.n
    nb = -(-n // block)
    rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
    cols = csr.indices.astype(np.int64)
    vals = np.asarray(mvals, np.float64)
    keep = cols < rows if lower else cols >= rows
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    diag_blocks = np.tile(np.eye(block), (nb, 1, 1))
    inb = rows // block == cols // block
    diag_blocks[rows[inb] // block, rows[inb] % block,
                cols[inb] % block] = vals[inb]

    orow, ocol, oval = rows[~inb], cols[~inb], vals[~inb]
    counts = np.bincount(orow, minlength=nb * block)
    kmax = max(1, int(counts.max()) if counts.size else 1)
    first = np.cumsum(counts) - counts          # first off-block slot per row
    pos = np.arange(orow.shape[0]) - first[orow]
    ell_vals = np.zeros((nb, block, kmax), dtype=np.float64)
    ell_cols = np.zeros((nb, block, kmax), dtype=np.int32)
    ell_vals[orow // block, orow % block, pos] = oval
    ell_cols[orow // block, orow % block, pos] = ocol
    w = np.linalg.inv(diag_blocks)
    return w, ell_vals, ell_cols


@dataclasses.dataclass(frozen=True)
class BlockTriangularSolver:
    """Device pytree implementing ``x = U \\ (L \\ f)`` for a combined ILU(0)
    factor, via the blocked recurrence described in the module docstring."""

    w_lo: jax.Array    # [nb, B, B] inverse of unit-lower diagonal blocks
    vals_lo: jax.Array # [nb, B, Klo]
    cols_lo: jax.Array # int32[nb, B, Klo] (global row indices)
    w_up: jax.Array    # [nb, B, B] inverse of upper diagonal blocks
    vals_up: jax.Array # [nb, B, Kup]
    cols_up: jax.Array # int32[nb, B, Kup]
    n: int             # static: true dimension
    block: int         # static

    @classmethod
    def from_factor(cls, csr, mvals: np.ndarray, block: int = 256,
                    dtype=jnp.float64) -> "BlockTriangularSolver":
        w_lo, vals_lo, cols_lo = _block_setup_tri(csr, mvals, block, lower=True)
        w_up, vals_up, cols_up = _block_setup_tri(csr, mvals, block, lower=False)
        return cls(
            jnp.asarray(w_lo, dtype=dtype), jnp.asarray(vals_lo, dtype=dtype),
            jnp.asarray(cols_lo), jnp.asarray(w_up, dtype=dtype),
            jnp.asarray(vals_up, dtype=dtype), jnp.asarray(cols_up),
            csr.n, block)

    @property
    def nb(self) -> int:
        return self.w_lo.shape[0]

    def _sweep(self, f: jax.Array, w, vals, cols, forward: bool) -> jax.Array:
        nb, block = self.nb, self.block
        npad = nb * block
        fp = jnp.zeros(npad, f.dtype).at[: self.n].set(f)
        dt = jnp.result_type(w, f)

        def body(step, y):
            b = step if forward else nb - 1 - step
            cols_b = jax.lax.dynamic_index_in_dim(cols, b, keepdims=False)
            vals_b = jax.lax.dynamic_index_in_dim(vals, b, keepdims=False)
            w_b = jax.lax.dynamic_index_in_dim(w, b, keepdims=False)
            f_b = jax.lax.dynamic_slice(fp, (b * block,), (block,))
            gathered = jnp.take(y, cols_b)                     # (B, K)
            rhs = f_b - jnp.sum(vals_b * gathered, axis=1)     # (B,)
            # full f32 precision: a TF32 product would cost the solve ~3
            # decimal digits per sweep
            y_b = jnp.dot(w_b, rhs, preferred_element_type=dt,
                          precision=jax.lax.Precision.HIGHEST)
            return jax.lax.dynamic_update_slice(y, y_b.astype(y.dtype),
                                                (b * block,))

        # derive the init carry from fp (not a fresh constant) so that under
        # shard_map with vma checking the carry is marked device-varying like
        # the loop output (a plain jnp.zeros is unvarying and trips the check)
        y = (fp * 0).astype(dt)
        y = jax.lax.fori_loop(0, nb, body, y)
        return y[: self.n]

    def solve_lower(self, f: jax.Array) -> jax.Array:
        """L y = f with unit-diagonal lower factor (forward sweep)."""
        return self._sweep(f, self.w_lo, self.vals_lo, self.cols_lo,
                           forward=True)

    def solve_upper(self, f: jax.Array) -> jax.Array:
        """U x = f with non-unit upper factor (backward sweep)."""
        return self._sweep(f, self.w_up, self.vals_up, self.cols_up,
                           forward=False)

    def msolve(self, f: jax.Array) -> jax.Array:
        """Apply the preconditioner: ``M⁻¹ f = U \\ (L \\ f)`` — the two
        csrsv_solve calls of the reference loop (pbicgstab.cu:92-98)."""
        return self.solve_upper(self.solve_lower(f))


jax.tree_util.register_dataclass(
    BlockTriangularSolver,
    data_fields=["w_lo", "vals_lo", "cols_lo", "w_up", "vals_up", "cols_up"],
    meta_fields=["n", "block"],
)
