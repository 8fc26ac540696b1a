"""Device-resident sparse linear operators (JAX pytrees).

Each operator owns device arrays and provides ``matvec(x)``, replacing the
reference's ``cusparseDcsrmv`` call sites (reference pbicgstab.cu:67,104,132,
469,501,528) and its one custom kernel — the fused ``y = d∘x + A0·x`` of the
split form (``mult_spec`` + csrmv-with-beta=1, reference pbicgstab.cu:36-42,
:675-676).  Operators are pytrees, so they can be closed over or passed as
arguments to ``jit``-compiled solver loops and sharded with ``shard_map``.

Format choice is a load-time decision made in one place,
:func:`cuda_mat.ops.selection.select_format`:

- DIA  — few distinct diagonals, dense enough: no-gather shifted multiply-add
         (the banded fixtures mat900/mat10000 and all Laplacian workloads)
- ELL  — bounded row length: one rectangular gather + row reduction
- CSR  — fallback: segment-sum over nnz
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def shifted(x: jax.Array, off: int, length: int) -> jax.Array:
    """``z[i] = x[i + off]`` for ``i`` in ``[0, length)``, zero where
    ``i + off`` leaves ``x``.  Built as a pad of a slice, used once per
    term: XLA fuses every such term of a sum into one loop over the output
    (a single zero-padded copy of x read at several offsets would instead be
    materialized as a kernel of its own)."""
    start = min(max(0, off), x.shape[0])
    stop = max(start, min(x.shape[0], length + off))
    lo = min(max(0, -off), length)
    return jnp.pad(x[start:stop], (lo, length - lo - (stop - start)))


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=data_fields,
                                     meta_fields=meta_fields)
    return cls


@dataclasses.dataclass(frozen=True)
class CSROperator:
    """CSR SpMV via segment-sum: ``y = segsum(data * x[indices], row_ids)``.

    ``row_ids`` (the COO row index of every nnz) is precomputed at load time
    so the device op is pure gather/multiply/segment-sum.
    """

    data: jax.Array      # [nnz]
    indices: jax.Array   # int32[nnz]
    row_ids: jax.Array   # int32[nnz]
    n: int               # static
    m: int               # static

    def matvec(self, x: jax.Array) -> jax.Array:
        prod = self.data * jnp.take(x, self.indices)
        return jax.ops.segment_sum(prod, self.row_ids, num_segments=self.n,
                                   indices_are_sorted=True)


_register(CSROperator, ["data", "indices", "row_ids"], ["n", "m"])


@dataclasses.dataclass(frozen=True)
class ELLOperator:
    """ELL SpMV: ``y = sum_k values[:, k] * x[cols[:, k]]`` — one rectangular
    gather + a row reduction, fully fuseable by XLA."""

    values: jax.Array  # [n, K]
    cols: jax.Array    # int32[n, K]
    m: int             # static

    @property
    def n(self) -> int:
        return self.values.shape[0]

    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.sum(self.values * jnp.take(x, self.cols, axis=0), axis=1)


_register(ELLOperator, ["values", "cols"], ["m"])


@dataclasses.dataclass(frozen=True)
class DIAOperator:
    """Banded (DIA) SpMV: ``y = sum_d data[d] * shift(x, off_d)`` — no gather.

    ``offsets`` is a static tuple, so the trace unrolls into one elementwise
    sum of shifted copies of x (:func:`shifted`; row-aligned DIA data is
    zero wherever a diagonal leaves the matrix), which XLA fuses into a
    single loop over the rows.  This is the speed-of-light formulation for
    the reference's banded fixtures.
    """

    data: jax.Array            # [ndiag, n] row-aligned
    offsets: Tuple[int, ...]   # static, ascending
    m: int                     # static

    @property
    def n(self) -> int:
        return self.data.shape[1]

    def matvec(self, x: jax.Array) -> jax.Array:
        acc = None
        for d, off in enumerate(self.offsets):
            t = self.data[d] * shifted(x, off, self.n)
            acc = t if acc is None else acc + t
        return acc


_register(DIAOperator, ["data"], ["offsets", "m"])


@dataclasses.dataclass(frozen=True)
class BELLOperator:
    """Blocked-ELL SpMV: BSR rows padded to a uniform ``kmax`` blocks, so the
    contraction is one block-granular gather + a batched (bs,bs)@(bs,) matmul
    instead of element gathers (for matrices with dense sub-blocks).

        y_r = sum_k  values[r, k] @ xb[cols[r, k]]

    The gather moves whole contiguous ``bs``-element rows of ``xb``.  Padding
    blocks are all-zero and point at block-column 0.  Forced with
    ``format="bell"``; never chosen automatically.
    """

    values: jax.Array   # [nbr, kmax, bs, bs]
    cols: jax.Array     # int32[nbr, kmax]
    n: int              # static true rows
    m: int              # static true cols

    @property
    def bs(self) -> int:
        return self.values.shape[-1]

    @classmethod
    def from_csr(cls, csr, bs: int = 128, dtype=jnp.float32
                 ) -> "BELLOperator":
        bsr = csr.to_bsr(block=bs)
        nbr = bsr.nbrows
        counts = np.diff(bsr.indptr)
        kmax = max(int(counts.max()) if nbr else 1, 1)
        values = np.zeros((nbr, kmax, bs, bs), dtype=np.dtype(dtype))
        cols = np.zeros((nbr, kmax), dtype=np.int32)
        rows_of_block = np.repeat(np.arange(nbr), counts)
        pos = np.arange(len(bsr.indices)) - bsr.indptr[rows_of_block]
        values[rows_of_block, pos] = bsr.blocks
        cols[rows_of_block, pos] = bsr.indices
        return cls(jnp.asarray(values), jnp.asarray(cols), csr.n, csr.m)

    def matvec(self, x: jax.Array) -> jax.Array:
        bs = self.bs
        nbc = -(-self.m // bs)
        xp = jnp.zeros(nbc * bs, x.dtype).at[: self.m].set(x[: self.m])
        xb = xp.reshape(nbc, bs)
        xg = jnp.take(xb, self.cols, axis=0)        # [nbr, kmax, bs]
        # precision=HIGHEST: a reduced-precision f32 product (TF32 on the
        # GPU) measurably degrades the BiCGSTAB residual recurrences; the op
        # is bandwidth-bound, so full f32 costs nothing
        y = jnp.einsum("rkab,rkb->ra", self.values, xg,
                       preferred_element_type=x.dtype,
                       precision=jax.lax.Precision.HIGHEST)
        return y.reshape(-1)[: self.n]


_register(BELLOperator, ["values", "cols"], ["n", "m"])


@dataclasses.dataclass(frozen=True)
class SplitOperator:
    """Fused split-form operator ``A = A0 + diag(d)``:
    ``matvec(x) = d∘x + A0·x`` in one trace (reference's mult_spec + csrmv
    accumulate pair, pbicgstab.cu:675-676)."""

    a0: object          # any operator pytree
    d: jax.Array        # [n]

    @property
    def n(self) -> int:
        return self.a0.n

    @property
    def m(self) -> int:
        return self.a0.m

    def matvec(self, x: jax.Array) -> jax.Array:
        return self.d * x + self.a0.matvec(x)


_register(SplitOperator, ["a0", "d"], [])


@dataclasses.dataclass(frozen=True)
class DenseOperator:
    """Dense matvec — for tiny systems (mat3) and testing."""

    a: jax.Array

    @property
    def n(self) -> int:
        return self.a.shape[0]

    @property
    def m(self) -> int:
        return self.a.shape[1]

    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.dot(self.a, x, precision=jax.lax.Precision.HIGHEST)


_register(DenseOperator, ["a"], [])


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def make_operator(csr, dtype=jnp.float64, format: Optional[str] = None):
    """Build a plain-vector device operator for a host CSR matrix.

    ``format`` forces one of {"csr", "ell", "dia", "bell", "dense"}; by
    default :func:`~cuda_mat.ops.selection.select_format` decides from the
    structure.  A constant-coefficient stencil runs here in its DIA form: the
    matrix-free :class:`~cuda_mat.ops.stencil.ConstStencilOperator` works on
    gap-strided vectors, which only the solver loops set up.
    """
    from cuda_mat.ops.selection import check_platform, select_format

    check_platform()
    if format is None:
        format, _ = select_format(csr)
        if format == "stencil":
            format = "dia"
    if format == "bell":
        return BELLOperator.from_csr(csr, dtype=dtype)
    if format == "dense":
        return DenseOperator(jnp.asarray(csr.to_dense(), dtype=dtype))
    if format == "dia":
        dia = csr.to_dia()
        return DIAOperator(jnp.asarray(dia.data, dtype=dtype),
                           tuple(int(o) for o in dia.offsets), csr.m)
    if format == "ell":
        ell = csr.to_ell()
        return ELLOperator(jnp.asarray(ell.values, dtype=dtype),
                           jnp.asarray(ell.cols), csr.m)
    if format == "csr":
        row_ids = np.repeat(np.arange(csr.n, dtype=np.int32), csr.row_lengths)
        return CSROperator(jnp.asarray(csr.data, dtype=dtype),
                           jnp.asarray(csr.indices), jnp.asarray(row_ids),
                           csr.n, csr.m)
    raise ValueError(f"unknown operator format {format!r}")
