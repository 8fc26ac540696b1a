"""Constant-coefficient grid stencils in the gap-strided layout.

The headline workloads are 2-D Laplacians on an R×C grid (mat900 = GR_30_30,
mat10000 = 100×100, the 1M/10M-row solve configs — reference
mat10000.mtx:1-5).  Viewed as a matrix they are banded with offsets
{±1, ±C, 0}; viewed as a *grid* they are a stencil with constant
coefficients:

    y[i,j] = Σ_k  scal_k · x[i+dr_k, j+dc_k]

so a matvec needs no coefficient streams at all: it reads x once and writes
y once (~2n words instead of the DIA form's (ndiag+2)n).

**Gap-strided layout.**  Each grid row of C cells is stored with stride
``S = C + gap`` and the gap cells hold zeros.  A stencil read that crosses a
row boundary (the ±1 "seam" entries a flat layout has to mask per element)
then lands in a zero gap cell, so boundary handling is free, and the product
of two stencils is again exact on this layout while every accumulated
``|dc| <= gap`` (a within-row read that leaves the true columns sees the zero
the sequential application would have re-masked).  That is what lets the
Neumann-series preconditioner collapse ``Σ_{j<k} (−N)^j`` into ONE stencil
(:func:`neumann_poly_terms`).

**Device form.**  A matvec is one elementwise sum of shifted copies of the
vector (zero past its ends), times the gap mask (:func:`stencil_matvec`);
XLA fuses it into a single loop over the vector.  Vectors in this layout are
a fixed point of the iteration: every output gap cell is an exact zero.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cuda_mat.ops.operators import shifted


# ---------------------------------------------------------------------------
# Device form
# ---------------------------------------------------------------------------


def shifted_sum(x: jax.Array, sterms, length: int, base: int = 0
                ) -> jax.Array:
    """``y[i] = Σ_k scal_k · x[base + i + off_k]`` for ``i`` in
    ``[0, length)``, reading zeros outside ``x`` — the stencil sum, as one
    fusable elementwise expression (:func:`~cuda_mat.ops.operators.shifted`).
    Coefficients are Python floats, so they take the vector's dtype."""
    acc = None
    for off, scal in sterms:
        t = scal * shifted(x, base + off, length)
        acc = t if acc is None else acc + t
    return acc


def gap_mask(y: jax.Array, c_grid: int, stride: int,
             row0=None, rows: Optional[int] = None) -> jax.Array:
    """Zero the gap cells of a strided vector (column >= ``c_grid`` of each
    ``stride``-long grid row).  With ``rows``, also zero grid rows whose
    global index ``row0 + local row`` is >= ``rows`` (the tail that pads a
    row partition)."""
    y2 = y.reshape(-1, stride)
    keep = jax.lax.broadcasted_iota(jnp.int32, y2.shape, 1) < c_grid
    if rows is not None:
        grow = row0 + jax.lax.broadcasted_iota(jnp.int32, y2.shape, 0)
        keep = keep & (grow < rows)
    return jnp.where(keep, y2, jnp.zeros_like(y2)).reshape(-1)


def stencil_matvec(x: jax.Array, sterms, c_grid: int, stride: int
                   ) -> jax.Array:
    """``y = A x`` for a constant stencil on a gap-strided vector ``x``
    (length R·S); ``sterms`` are ``(strided offset, scalar)`` pairs."""
    return gap_mask(shifted_sum(x, sterms, x.shape[0]), c_grid, stride)


# ---------------------------------------------------------------------------
# Structure detection and stencil algebra (host)
# ---------------------------------------------------------------------------


def detect_const_stencil(dia, dc_max: int = 8, dr_max: int = 8):
    """Detect constant-coefficient 2-D grid-stencil structure in a DIA matrix.

    Returns ``(c_grid, terms)`` with ``terms = ((off, dc, scal), ...)`` when
    the matrix is exactly ``A[(gi,gj),(gi+dr,gj+dc)] = scal_k`` on an R×C
    grid (entries whose neighbor leaves the grid are zero), else ``None``.
    Candidates for C are the |offsets| > dc_max (an offset too large to be a
    within-row step must be a row step); the grid interpretation is verified
    exactly against the stored diagonal data, so a successful detection is a
    proof, not a heuristic.
    """
    if dia.n != dia.m or dia.ndiag == 0:
        return None
    n = dia.n
    offs = [int(o) for o in dia.offsets]
    cands = sorted({abs(o) for o in offs if abs(o) > dc_max}, reverse=True)
    if cands:
        # cheap short-circuit before the exact O(ndiag*n) verification: every
        # diagonal of a constant stencil has at most two distinct values
        # (the scalar + boundary zeros) — a strided sample proves most
        # non-stencil matrices are not candidates in O(ndiag * n/step)
        step = max(1, n // 4096)
        for d in range(len(offs)):
            if np.unique(dia.data[d, ::step]).size > 2:
                return None
    idx = np.arange(n, dtype=np.int64)
    for c in cands:
        if n % c or n // c < 2:
            continue
        gj = idx % c
        terms = []
        ok = True
        for d, off in enumerate(offs):
            dr = int(np.rint(off / c))
            dc = off - dr * c
            if abs(dc) > dc_max or abs(dr) > dr_max:
                ok = False
                break
            data = dia.data[d]
            valid = (gj + dc >= 0) & (gj + dc < c)
            # row-direction validity: i + off in [0, n) is already implied by
            # row-aligned DIA construction (out-of-range slots are 0) — but
            # those zero slots must not break the constant check, so restrict
            # to in-range rows as well
            lo, hi = max(0, -off), min(n, n - off)
            valid = valid & (idx >= lo) & (idx < hi)
            vals = data[valid]
            if vals.size == 0 or np.any(vals != vals[0]) \
                    or np.any(data[~valid] != 0):
                ok = False
                break
            terms.append((off, dc, float(vals[0])))
        if ok:
            return c, tuple(terms)
    return None


def strided_offsets(terms, c_grid: int, stride: int):
    """``((off', scal), ...)`` in the strided coordinates (``off' = dr·S +
    dc``) from true-coordinate ``(off, dc, scal)`` terms."""
    return tuple((((t[0] - t[1]) // c_grid) * stride + t[1], float(t[2]))
                 for t in terms)


def stencil_layout(c_grid: int, n: int, terms, gap: int = 0):
    """The gap-strided layout ``(stride, np_true, strided_terms)`` of an
    n = R·C grid: ``stride = C + max(gap, max|dc|)`` — the gap must at least
    hold the stencil's own within-row reach so seam reads land on zeros;
    ``gap`` widens it for stencil polynomials (:func:`series_gap`)."""
    dcmax = max((abs(t[1]) for t in terms), default=0)
    stride = c_grid + max(gap, dcmax)
    np_true = (n // c_grid) * stride
    return stride, np_true, strided_offsets(terms, c_grid, stride)


def series_gap(terms, k: int) -> int:
    """Gap width that keeps the k-term Neumann series of either triangle of
    a stencil with these terms exact (ILU(0) factors share A's pattern, and
    a j-th power reaches j times the within-row step)."""
    return max(k - 1, 1) * max((abs(t[1]) for t in terms), default=0)


def compose_stencil_terms(ta, tb, c_grid: int, stride: int):
    """Product stencil ``C = A·B`` of two constant stencils (polynomial
    multiplication over (dr, dc) offsets) — exact on the gap-strided layout
    while every accumulated ``|dc| <= stride − c_grid``.  Raises ValueError
    past the gap."""
    gap = stride - c_grid
    out = {}
    for (o1, d1, v1) in ta:
        for (o2, d2, v2) in tb:
            k = (o1 + o2, d1 + d2)
            out[k] = out.get(k, 0.0) + v1 * v2
    res = []
    for (off, dc), v in sorted(out.items()):
        if abs(dc) > gap and dc != 0:
            raise ValueError(f"composed term dc={dc} exceeds the gap width"
                             f" {gap} (stride {stride}, C {c_grid})")
        if v != 0.0:
            res.append((off, dc, float(v)))
    return tuple(res)


def neumann_poly_terms(terms, k: int, c_grid: int, stride: int):
    """Expand the truncated Neumann series ``P = Σ_{j<k} (−N)^j`` of a
    constant-stencil ``N`` into a single constant stencil.

    Stencil composition is polynomial multiplication over (dr, dc) offsets
    (:func:`compose_stencil_terms`); it is exact on the gap-strided layout
    as long as every accumulated ``|dc| <= stride − c_grid`` (row offsets
    beyond the grid land in the zero-extended ends).  One matvec then applies
    the whole series, replacing ``k−1`` matvecs plus their series adds.

    ``terms``: ((off, dc, scal), ...) of N.  Returns the same format for P,
    or raises ValueError when an accumulated |dc| exceeds the gap width.
    """
    acc = {(0, 0): 1.0}                                # I
    cur = tuple(terms)                                 # N^j
    for j in range(1, k):
        sign = -1.0 if j % 2 else 1.0
        for (off, dc, v) in cur:
            acc[(off, dc)] = acc.get((off, dc), 0.0) + sign * v
        if j + 1 < k:
            cur = compose_stencil_terms(cur, terms, c_grid, stride)
    gap = stride - c_grid
    out = []
    for (off, dc), v in sorted(acc.items()):
        if abs(dc) > gap and dc != 0:
            raise ValueError(
                f"series term dc={dc} exceeds the gap width {gap}"
                f" (stride {stride}, C {c_grid}); apply the series"
                " term-by-term instead")
        if v != 0.0:
            out.append((off, dc, float(v)))
    return tuple(out)


def const_factor_terms(dia, c_grid: int, stride: int):
    """Deep-interior constant-stencil approximation of a banded matrix on an
    R×C grid: sample each diagonal at a row where every offset is in-range
    (grid center) and return ``(terms, strided_terms)`` in the formats of
    :class:`ConstStencilOperator` (``(off, dc, scal)`` / ``(off', scal)``).

    Used for ILU(0) Neumann factors of constant stencils, whose diagonals
    converge geometrically to interior fixed points away from the boundary
    (the approximation perturbs only a boundary layer of the
    *preconditioner*; see NeumannILUPreconditioner.from_csr)."""
    n = dia.n
    r = n // c_grid
    assert n % c_grid == 0
    i0 = (r // 2) * c_grid + c_grid // 2
    terms = []
    sterms = []
    for k, off in enumerate(int(o) for o in dia.offsets):
        dr = int(np.rint(off / c_grid))
        dc = off - dr * c_grid
        if abs(dc) > stride - c_grid and dc != 0:
            raise ValueError(f"offset {off}: |dc|={abs(dc)} exceeds the gap"
                             f" width {stride - c_grid}")
        if not (0 <= i0 + off < n and 0 <= (i0 % c_grid) + dc < c_grid):
            raise ValueError(f"offset {off} has no interior sample row on an"
                             f" {r}x{c_grid} grid")
        scal = float(dia.data[k, i0])
        terms.append((off, dc, scal))
        sterms.append((dr * stride + dc, scal))
    return tuple(terms), tuple(sterms)


def restride_dia(dia, c_grid: int, stride: int):
    """Re-index an n = R·C banded matrix into the gap-strided coordinate
    system (n' = R·S): entry (i, j) moves to (i', j') with
    i' = (i//C)·S + i%C.  Gap rows/columns are structurally zero, so the
    result is again banded with offsets mapped dr·C + dc → dr·S + dc.

    Used to build exact-pattern factor operators (ILU(0) Neumann-series N_l /
    N_u) that compose with a :class:`ConstStencilOperator`'s vectors — the
    DIA data itself provides the gap masking (zero slots), so a plain
    :class:`~cuda_mat.ops.operators.DIAOperator` over the restrided matrix
    preserves the fixed-point property.
    """
    from cuda_mat.formats.dia import DIAMatrix

    n = dia.n
    assert n % c_grid == 0
    r = n // c_grid
    np_true = r * stride
    offs = [int(o) for o in dia.offsets]
    new_offs = []
    for off in offs:
        dr = int(np.rint(off / c_grid))
        dc = off - dr * c_grid
        if abs(dc) > stride - c_grid and dc != 0:
            raise ValueError(f"offset {off}: |dc|={abs(dc)} exceeds the gap"
                             f" width {stride - c_grid}")
        new_offs.append(dr * stride + dc)
    order = np.argsort(new_offs)
    data = np.zeros((dia.ndiag, np_true), dtype=dia.data.dtype)
    idx = np.arange(n, dtype=np.int64)
    pos = (idx // c_grid) * stride + (idx % c_grid)
    for k, d in enumerate(order):
        data[k, pos] = dia.data[d]
    return DIAMatrix(np_true, np_true,
                     np.asarray([new_offs[d] for d in order], np.int32),
                     data, dia.nnz)


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConstStencilOperator:
    """Matrix-free device operator for constant-coefficient grid stencils in
    the gap-strided layout (see the module docstring).

    Padded-vector protocol: the solver loops run on strided vectors
    (:meth:`pad_vec` / :meth:`unpad_vec` at the boundary), whose zero gap
    cells are a fixed point of :meth:`matvec`.  Factor operators built to
    compose with this one (Neumann series N_l/N_u) share the layout: same
    ``c_grid``/``stride``, other ``terms`` (``dataclasses.replace``).
    Replaces the reference's csrmv call sites pbicgstab.cu:104,132.

    The operator holds no arrays: every field is static.
    """

    terms: Tuple[Tuple[int, int, float], ...]  # true-coord (off, dc, scal)
    strided_terms: Tuple[Tuple[int, float], ...]  # (off', scal)
    c_grid: int                # grid row length C
    stride: int                # strided row length S = C + gap
    n: int                     # true dimension R*C
    vec_dtype: str = "float32"

    @property
    def m(self) -> int:
        return self.n

    @property
    def r(self) -> int:
        return self.n // self.c_grid

    @property
    def np_true(self) -> int:
        """Length of a vector in the strided layout (R·S)."""
        return self.r * self.stride

    @property
    def nnz(self) -> int:
        nz = 0
        for off, dc, _ in self.terms:
            lo, hi = max(0, -off), min(self.n, self.n - off)
            cnt = hi - lo
            if dc:
                gj = np.arange(lo, hi, dtype=np.int64) % self.c_grid
                cnt = int(np.count_nonzero((gj + dc >= 0) & (gj + dc
                                                             < self.c_grid)))
            nz += cnt
        return nz

    @classmethod
    def from_terms(cls, terms, c_grid: int, n: int, dtype=jnp.float32,
                   gap: int = 0) -> "ConstStencilOperator":
        stride, _, sterms = stencil_layout(c_grid, n, terms, gap)
        return cls(tuple(terms), sterms, c_grid, stride, n,
                   str(np.dtype(dtype)))

    @classmethod
    def from_dia(cls, dia, dtype=jnp.float32, gap: int = 0
                 ) -> "ConstStencilOperator":
        det = detect_const_stencil(dia)
        if det is None:
            raise ValueError(
                "matrix is not a constant-coefficient grid stencil; use"
                " make_operator instead")
        c_grid, terms = det
        return cls.from_terms(terms, c_grid, dia.n, dtype, gap)

    def with_gap(self, gap: int) -> "ConstStencilOperator":
        """The same stencil in a layout with at least ``gap`` gap cells."""
        return self.from_terms(self.terms, self.c_grid, self.n,
                               self.vec_dtype, gap)

    def pad_vec(self, v) -> jax.Array:
        dt = jnp.dtype(self.vec_dtype)
        v2 = jnp.asarray(v, dt).reshape(self.r, self.c_grid)
        return jnp.pad(v2, ((0, 0), (0, self.stride - self.c_grid))
                       ).reshape(-1)

    def unpad_vec(self, v_pad: jax.Array) -> jax.Array:
        g = v_pad.reshape(self.r, self.stride)
        return g[:, : self.c_grid].reshape(-1)

    def matvec(self, x_pad: jax.Array) -> jax.Array:
        return stencil_matvec(x_pad, self.strided_terms, self.c_grid,
                              self.stride)


jax.tree_util.register_dataclass(
    ConstStencilOperator, data_fields=[],
    meta_fields=["terms", "strided_terms", "c_grid", "stride", "n",
                 "vec_dtype"])
