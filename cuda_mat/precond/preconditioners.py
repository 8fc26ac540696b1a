"""Preconditioners as device pytrees with an ``msolve`` method.

The reference supports exactly one preconditioner — ILU(0) applied through
two cuSPARSE triangular solves (reference pbicgstab.cu:92-98,:356-363) — and
none for the other two entry points.  Here the preconditioner is a
first-class pluggable object; Jacobi is the cheap bandwidth-bound option
for diagonally dominant systems, ILU(0) matches the reference path exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cuda_mat.ops.trisolve import BlockTriangularSolver
from cuda_mat.reference.cpu_solvers import ilu0_factorize


@dataclasses.dataclass(frozen=True)
class IdentityPreconditioner:
    """M = I (the unpreconditioned paths, reference pbicgstab.cu:425-754)."""

    def msolve(self, f: jax.Array) -> jax.Array:
        return f


jax.tree_util.register_dataclass(IdentityPreconditioner, data_fields=[],
                                 meta_fields=[])


@dataclasses.dataclass(frozen=True)
class JacobiPreconditioner:
    """M = diag(A): one multiply per application."""

    inv_diag: jax.Array

    @classmethod
    def from_csr(cls, csr, dtype=jnp.float64) -> "JacobiPreconditioner":
        d = csr.diagonal()
        if np.any(d == 0):
            raise ValueError("Jacobi preconditioner requires a nonzero diagonal")
        return cls(jnp.asarray(1.0 / d, dtype=dtype))

    def msolve(self, f: jax.Array) -> jax.Array:
        return self.inv_diag * f


jax.tree_util.register_dataclass(JacobiPreconditioner, data_fields=["inv_diag"],
                                 meta_fields=[])


@dataclasses.dataclass(frozen=True)
class ILU0Preconditioner:
    """ILU(0): zero-fill incomplete factors on A's pattern, applied with the
    blocked triangular solver (see :mod:`cuda_mat.ops.trisolve`).

    Factorization happens once at setup on the host (the reference also
    treats it as a one-time setup phase, timed separately at
    pbicgstab.cu:356-363); the native C++ factorizer is used when built.
    """

    tri: object  # BlockTriangularSolver

    @classmethod
    def from_csr(cls, csr, block: int = 256, dtype=jnp.float64,
                 milu_omega: float = 0.0) -> "ILU0Preconditioner":
        """``milu_omega``: relaxed modified-ILU(0) factor values
        (:func:`milu0_factorize`); 0 = reference-parity ILU(0)."""
        # The blocked trisolve precomputes per-block inverses: O(n*B) floats.
        # Refuse configurations that would silently eat gigabytes at setup
        # (a 1M-row, B=1024 factor is ~8 GB of inverses and minutes of host
        # np.linalg.inv) — at that scale use Jacobi, solve_refined, or the
        # distributed block-Jacobi ILU(0).
        nb = -(-csr.n // block)
        w_bytes = 2 * nb * block * block * np.dtype(dtype).itemsize
        if w_bytes > (2 << 30):
            raise ValueError(
                f"ILU(0) blocked trisolve would precompute {w_bytes / 2**30:.1f}"
                f" GiB of block inverses (n={csr.n}, block={block}); use"
                f" precond='jacobi', solve_refined, or the distributed"
                f" bjacobi_ilu0 for systems this large")
        mvals = _factorize(csr, milu_omega)
        return cls(BlockTriangularSolver.from_factor(csr, mvals, block=block,
                                                     dtype=dtype))

    def msolve(self, f: jax.Array) -> jax.Array:
        return self.tri.msolve(f)


jax.tree_util.register_dataclass(ILU0Preconditioner, data_fields=["tri"],
                                 meta_fields=[])


@dataclasses.dataclass(frozen=True)
class NeumannILUPreconditioner:
    """ILU(0) applied by a *truncated Neumann series* instead of triangular
    solves — the bandwidth-bound formulation for large n (the
    "Jacobi-iteration approximation" alternative named in SURVEY §7).

    With ``L = I + N_l`` (unit lower) and ``U = D(I + N_u)``,
    ``N_u = D⁻¹ · strict_upper``:

        L⁻¹ ≈ Σ_{j<k} (−N_l)ʲ        U⁻¹ ≈ (Σ_{j<k} (−N_u)ʲ) D⁻¹

    so one application is ``2(k−1)`` *banded SpMVs* — streaming work —
    instead of sequential sweeps over O(n·B) block inverses.  The
    preconditioner is approximate: iteration counts rise relative to exact
    ILU(0); convergence of the series needs ρ(N) < 1, which holds for the
    diagonally-dominant/M-matrix factors of the headline workloads.
    """

    nl: object       # strict-lower operator (any matvec pytree), or the
                     # whole-series polynomial P_l when ``fused``
    nu: object       # D⁻¹·strict-upper operator, or P_u when ``fused``
    inv_d: jax.Array
    terms: int       # static k (total series terms; k=1 degrades to Jacobi)
    fused: bool = False  # static: nl/nu are whole-series stencils, so
                     # msolve = P_u·(inv_d ∘ P_l·x) — two stencil matvecs

    @classmethod
    def from_csr(cls, csr, dtype=jnp.float32, terms: int = 3,
                 pad_like=None, const_factors: bool = True,
                 milu_omega: float = 0.0) -> "NeumannILUPreconditioner":
        """``pad_like``: a :class:`~cuda_mat.ops.stencil.ConstStencilOperator`
        for A — build N_l/N_u in its gap-strided layout, so the whole msolve
        maps strided vectors to strided vectors (zero gaps are a fixed point
        of every term).

        ``const_factors`` (with ``pad_like``): approximate each factor
        diagonal by its deep-interior fixed-point value and run N_l/N_u
        matrix-free as stencils like A — the factor value streams (the
        dominant msolve traffic) vanish, and each triangle's series collapses
        into one stencil when its polynomial fits the layout's gap.  The ILU
        recurrence of a constant stencil converges geometrically away from
        the boundary, so only a boundary layer (~3-5% of entries on the
        measured grids) is perturbed; this changes the *preconditioner*, not
        the system — the exact diagonal D stays a vector, convergence is
        still measured against A.  ``const_factors=False`` keeps the exact
        factors, restrided into the layout as DIA operators."""
        from cuda_mat.ops.operators import DIAOperator, make_operator

        low, up, diag = neumann_factors(csr, milu_omega)
        if pad_like is not None:
            inv_d = pad_like.pad_vec(1.0 / diag)
            if const_factors:
                nl = _const_factor_operator(low, pad_like)
                nu = _const_factor_operator(up, pad_like)
                fl = _fused_series_operator(nl, terms)
                fu = _fused_series_operator(nu, terms)
                if fl is not None and fu is not None:
                    return cls(fl, fu, inv_d, terms, fused=True)
                return cls(nl, nu, inv_d, terms)
            from cuda_mat.ops.stencil import restride_dia

            ops = []
            for f in (low, up):
                fd = restride_dia(f.to_dia(max_diags=128), pad_like.c_grid,
                                  pad_like.stride)
                ops.append(DIAOperator(jnp.asarray(fd.data, dtype),
                                       tuple(int(o) for o in fd.offsets),
                                       fd.m))
            return cls(ops[0], ops[1], inv_d, terms)
        return cls(make_operator(low, dtype=dtype),
                   make_operator(up, dtype=dtype),
                   jnp.asarray(1.0 / diag, dtype), terms)

    def msolve(self, f: jax.Array) -> jax.Array:
        if self.fused:
            return self.nu.matvec(self.inv_d * self.nl.matvec(f))
        y = f
        term = f
        for _ in range(self.terms - 1):
            term = -self.nl.matvec(term)
            y = y + term
        g = self.inv_d * y
        x = g
        term = g
        for _ in range(self.terms - 1):
            term = -self.nu.matvec(term)
            x = x + term
        return x


jax.tree_util.register_dataclass(NeumannILUPreconditioner,
                                 data_fields=["nl", "nu", "inv_d"],
                                 meta_fields=["terms", "fused"])


@dataclasses.dataclass(frozen=True)
class PaddedPreconditioner:
    """Adapt a true-n preconditioner to a padded-vector operator protocol.

    The stencil operator (:class:`~cuda_mat.ops.stencil.ConstStencilOperator`)
    runs the solver loop on gap-strided vectors; the exact triangular solvers
    work on true-n vectors.  This wrapper unpads at the msolve boundary and
    re-pads the result with exact zeros, so the gaps stay a fixed point of
    the whole preconditioned iteration and the SpMV never has to leave its
    layout.  Cost: two O(n) copies per application — small next to the
    O(n·B) sweep traffic.

    Reference role: the L/U solves feeding csrmv at pbicgstab.cu:92-104.
    """

    inner: object    # preconditioner over true-n vectors
    op: object       # padded operator providing pad_vec / unpad_vec

    def msolve(self, f_pad: jax.Array) -> jax.Array:
        return self.op.pad_vec(self.inner.msolve(self.op.unpad_vec(f_pad)))


jax.tree_util.register_dataclass(PaddedPreconditioner,
                                 data_fields=["inner", "op"],
                                 meta_fields=[])


def _fused_series_operator(n_op, k: int):
    """Whole-series stencil ``P = Σ_{j<k} (−N)^j`` sharing ``n_op``'s layout,
    or None when a polynomial offset exceeds the layout's gap width (the
    sequential series still applies)."""
    from cuda_mat.ops.stencil import neumann_poly_terms, strided_offsets

    try:
        pt = neumann_poly_terms(n_op.terms, k, n_op.c_grid, n_op.stride)
    except ValueError:
        return None
    return dataclasses.replace(
        n_op, terms=pt,
        strided_terms=strided_offsets(pt, n_op.c_grid, n_op.stride))


def _const_factor_operator(factor_csr, pad_like):
    """Matrix-free constant-stencil operator for an ILU factor, sharing
    ``pad_like``'s gap-strided layout (same stride, so strided vectors flow
    through A and the factors without relayout)."""
    from cuda_mat.ops.stencil import const_factor_terms

    fd = factor_csr.to_dia(max_diags=128)
    terms, sterms = const_factor_terms(fd, pad_like.c_grid, pad_like.stride)
    return dataclasses.replace(pad_like, terms=terms, strided_terms=sterms)


def neumann_factors(csr, milu_omega: float = 0.0):
    """ILU(0)-factorize ``csr`` and split the factor for the Neumann series:
    returns ``(N_l, N_u, diag)`` where ``N_l`` is the strict lower triangle of
    M (unit-lower L = I + N_l), ``N_u`` is D⁻¹·strict-upper (U = D(I + N_u)),
    both as host :class:`CSRMatrix`, and ``diag`` is D.  Shared by the
    single-chip :class:`NeumannILUPreconditioner` and the distributed
    row-partitioned path (reference msolve role: pbicgstab.cu:92-98).

    ``milu_omega`` > 0 switches to relaxed modified ILU(0)
    (:func:`milu0_factorize`) — a beyond-reference option that cuts
    iteration counts substantially on the Laplacian family
    (``test_milu_omega_cuts_iterations``); 0 (default) keeps the
    reference-parity ILU(0) factor."""
    from cuda_mat.formats.coo import COOMatrix
    from cuda_mat.formats.csr import CSRMatrix

    mvals = _factorize(csr, milu_omega)
    rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_lengths)
    cols = csr.indices.astype(np.int64)
    lower = cols < rows
    upper = cols > rows
    diag = np.zeros(csr.n)
    diag[rows[cols == rows]] = mvals[cols == rows]
    if np.any(diag == 0):
        raise ValueError("ILU(0) factor has a zero diagonal")
    if not lower.any() or not upper.any():
        raise ValueError("matrix has an empty strict triangle; use"
                         " precond='jacobi'")
    low = CSRMatrix.from_coo(COOMatrix(
        csr.n, csr.n, rows[lower].astype(np.int32),
        cols[lower].astype(np.int32), mvals[lower]))
    upv = mvals[upper] / diag[rows[upper]]  # D^-1 * strict upper
    up = CSRMatrix.from_coo(COOMatrix(
        csr.n, csr.n, rows[upper].astype(np.int32),
        cols[upper].astype(np.int32), upv))
    return low, up, diag


def _factorize(csr, milu_omega: float = 0.0) -> np.ndarray:
    try:
        from cuda_mat.native import loader as _native

        if _native.available():
            if milu_omega:
                return _native.milu0_factorize(csr, milu_omega)
            return _native.ilu0_factorize(csr)
    except ImportError:
        pass
    if milu_omega:
        return milu0_factorize(csr, milu_omega)
    return ilu0_factorize(csr)


def milu0_factorize(csr, omega: float) -> np.ndarray:
    """Relaxed modified ILU(0) (pure-numpy fallback; the native
    ``cmt_milu0`` agrees to accumulation-order ulps — the dropped-fill sum
    is a reduction): the IKJ elimination of
    :func:`~cuda_mat.reference.cpu_solvers.ilu0_factorize` restricted
    to the pattern, but each row's *dropped* fill (update terms at
    positions outside the pattern) is summed and ``omega`` times it is
    subtracted from the row's diagonal.  ``omega=1`` preserves A's row
    sums through L·U (classic MILU — O(h⁻¹) conditioning on the Laplacian
    family vs ILU(0)'s O(h⁻²)); ``0 < omega < 1`` is relaxed MILU, which
    keeps the factor diagonally dominant enough for the truncated Neumann
    series."""
    n = csr.n
    m = csr.data.astype(np.float64).copy()
    indptr, indices = csr.indptr, csr.indices
    diag_pos = np.empty(n, dtype=np.int64)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        js = indices[lo:hi]
        k = np.searchsorted(js, i)
        if k >= js.shape[0] or js[k] != i:
            raise ValueError(
                f"MILU(0) requires a stored nonzero diagonal (row {i})")
        diag_pos[i] = lo + k
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        dropped = 0.0
        for kk in range(lo, int(diag_pos[i])):
            k = indices[kk]
            pivot = m[diag_pos[k]]
            if pivot == 0.0:
                raise ValueError(f"MILU(0) zero pivot at row {k}")
            m[kk] = m[kk] / pivot
            lik = m[kk]
            klo, khi = int(diag_pos[k]) + 1, indptr[k + 1]
            if klo >= khi:
                continue
            row_i_js = indices[kk + 1:hi]
            row_k_js = indices[klo:khi]
            pos = np.searchsorted(row_i_js, row_k_js)
            ok = pos < row_i_js.shape[0]
            ok[ok] &= row_i_js[pos[ok]] == row_k_js[ok]
            upd = lik * m[klo:khi]
            m[kk + 1 + pos[ok]] -= upd[ok]
            dropped += float(upd[~ok].sum())
        m[diag_pos[i]] -= omega * dropped
    return m


def make_preconditioner(kind: str, csr, block: int = 256, dtype=jnp.float64,
                        terms: int = 3, milu_omega: float = 0.0):
    if kind in (None, "none", "identity"):
        return IdentityPreconditioner()
    if kind == "jacobi":
        return JacobiPreconditioner.from_csr(csr, dtype=dtype)
    if kind == "ilu0":
        return ILU0Preconditioner.from_csr(csr, block=block, dtype=dtype,
                                           milu_omega=milu_omega)
    if kind == "ilu0_neumann":
        return NeumannILUPreconditioner.from_csr(csr, dtype=dtype,
                                                 terms=terms,
                                                 milu_omega=milu_omega)
    raise ValueError(f"unknown preconditioner {kind!r}")
