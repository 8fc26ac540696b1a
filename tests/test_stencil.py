"""Matrix-free constant-stencil operator (gap-strided layout) vs the CSR
matvec, and its use by the solvers."""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_mat.models.problems import banded_laplacian


def _lap_grid(r, c):
    """R×C-grid 5-point Laplacian as CSR (banded_laplacian generalized)."""
    from cuda_mat.formats.coo import COOMatrix
    from cuda_mat.formats.csr import CSRMatrix

    n = r * c
    idx = np.arange(n, dtype=np.int64)
    rows = [idx]; cols = [idx]; data = [np.full(n, 4.0)]
    left = idx[idx % c != 0]
    rows += [left, left - 1]; cols += [left - 1, left]
    data += [np.full(left.shape[0], -1.0)] * 2
    up = idx[idx >= c]
    rows += [up, up - c]; cols += [up - c, up]
    data += [np.full(up.shape[0], -1.0)] * 2
    return CSRMatrix.from_coo(COOMatrix(n, n, np.concatenate(rows),
                                        np.concatenate(cols),
                                        np.concatenate(data)))


from cuda_mat.ops.stencil import (  # noqa: E402
    ConstStencilOperator, detect_const_stencil)


def test_detect_const_stencil_laplacian():
    dia = banded_laplacian(30).to_dia()
    det = detect_const_stencil(dia)
    assert det is not None
    c, terms = det
    assert c == 30
    assert {(off, dc) for off, dc, _ in terms} == {
        (-30, 0), (-1, -1), (0, 0), (1, 1), (30, 0)}
    assert {s for *_, s in terms} == {-1.0, 4.0}


def test_detect_const_stencil_ninepoint():
    from cuda_mat.models.problems import laplacian_2d

    dia = laplacian_2d(12).to_dia()
    det = detect_const_stencil(dia)
    assert det is not None
    c, terms = det
    assert c == 12 and len(terms) == 9
    assert {(off, dc) for off, dc, _ in terms} == {
        (-13, -1), (-12, 0), (-11, 1), (-1, -1), (0, 0), (1, 1),
        (11, -1), (12, 0), (13, 1)}


def test_detect_const_stencil_rejects_variable():
    dia = banded_laplacian(20).to_dia()
    dia.data[2, 7] = 5.0  # one interior diagonal entry off-constant
    assert detect_const_stencil(dia) is None


def test_detect_const_stencil_rejects_tridiagonal():
    # pure within-row band: no row-step offset, nothing to gain over DIA
    from cuda_mat.formats.coo import COOMatrix
    from cuda_mat.formats.csr import CSRMatrix

    n = 64
    i = np.arange(n)
    coo = COOMatrix(n, n, np.concatenate([i, i[1:], i[:-1]]),
                    np.concatenate([i, i[1:] - 1, i[:-1] + 1]),
                    np.concatenate([np.full(n, 2.0), np.full(n - 1, -1.0),
                                    np.full(n - 1, -1.0)]))
    assert detect_const_stencil(CSRMatrix.from_coo(coo).to_dia()) is None


@pytest.mark.parametrize("fixture", ["banded_laplacian", "laplacian_2d",
                                     "rect"])
def test_const_stencil_matches_csr(fixture, rng):
    from cuda_mat.models.problems import laplacian_2d

    if fixture == "banded_laplacian":
        a = banded_laplacian(30)
    elif fixture == "laplacian_2d":
        a = laplacian_2d(20)
    else:
        a = _lap_grid(40, 25)   # rectangular grid
    op = ConstStencilOperator.from_dia(a.to_dia(), dtype=jnp.float64)
    x = rng.standard_normal(a.n)
    y = np.asarray(op.unpad_vec(op.matvec(op.pad_vec(x))))
    np.testing.assert_allclose(y, a.matvec(x), rtol=1e-12, atol=1e-12)
    assert op.nnz == a.nnz


def test_const_stencil_pad_fixed_point(rng):
    a = banded_laplacian(30)
    op = ConstStencilOperator.from_dia(a.to_dia(), dtype=jnp.float64, gap=4)
    xp = op.pad_vec(rng.standard_normal(a.n))
    yp = np.asarray(op.matvec(xp))
    # every non-true-cell position (the gap cells) must be an exact zero so
    # strided vectors are a fixed point of the iteration
    true_cells = np.asarray(op.pad_vec(np.ones(a.n))) != 0.0
    assert np.all(yp[~true_cells] == 0.0)


def test_const_stencil_e2e_solve_matches_plain(rng):
    """solve() with format='stencil' reproduces the default-format result on
    the mat10000 pattern (ILU(0), the reference CLI default)."""
    from cuda_mat.config import SolverConfig
    from cuda_mat.solvers.bicgstab import solve

    a = banded_laplacian(30)
    b = rng.uniform(1.0, 5.0, a.n)
    cfg = SolverConfig(maxit=2000, tol=1e-8, dtype="float64", precond="ilu0",
                       trisolve_block=64)
    r_plain = solve(a, b, cfg)
    r_sten = solve(a, b, cfg, format="stencil")
    assert r_sten.status.name == r_plain.status.name == "CONVERGED"
    assert r_sten.iters == r_plain.iters
    np.testing.assert_allclose(r_sten.x, r_plain.x, rtol=1e-9, atol=1e-12)


def test_const_stencil_e2e_neumann(rng):
    """ilu0_neumann builds its factors in the stencil operator's padded
    layout (pad_like interop) and matches the unpadded result."""
    from cuda_mat.config import SolverConfig
    from cuda_mat.solvers.bicgstab import solve

    a = banded_laplacian(30)
    b = rng.uniform(1.0, 5.0, a.n)
    cfg = SolverConfig(maxit=2000, tol=1e-8, dtype="float64",
                       precond="ilu0_neumann", neumann_terms=3)
    r_sten = solve(a, b, cfg, format="stencil")
    r_dia = solve(a, b, cfg, format="dia")
    assert r_sten.status.name == "CONVERGED"
    assert r_sten.iters == r_dia.iters
    np.testing.assert_allclose(r_sten.x, r_dia.x, rtol=1e-9, atol=1e-12)


def test_format_stencil_rejects_nonstencil():
    from cuda_mat.config import SolverConfig
    from cuda_mat.models.problems import random_diag_nonzero_system
    from cuda_mat.solvers.bicgstab import solve

    a, b = random_diag_nonzero_system(50, prob_of_zero=0.9)
    with pytest.raises(ValueError):
        solve(a, b, SolverConfig(precond="none"), format="stencil")


def _grid9(r, c):
    """R×C-grid 9-point Laplacian (laplacian_2d generalized)."""
    from cuda_mat.formats.coo import COOMatrix
    from cuda_mat.formats.csr import CSRMatrix

    i = np.arange(r * c, dtype=np.int64)
    gr, gc = np.divmod(i, c)
    rows, cols, data = [i], [i], [np.full(r * c, 8.0)]
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                ok = ((gr + dr >= 0) & (gr + dr < r)
                      & (gc + dc >= 0) & (gc + dc < c))
                rows.append(i[ok])
                cols.append((i + dr * c + dc)[ok])
                data.append(np.full(int(ok.sum()), -1.0))
    return CSRMatrix.from_coo(COOMatrix(r * c, r * c, np.concatenate(rows),
                                        np.concatenate(cols),
                                        np.concatenate(data)))


@pytest.mark.parametrize("points,r,c,gap", [
    (5, 9, 17, 0),      # narrow grid, minimal gap
    (5, 2, 33, 0),      # two grid rows: every row is a boundary row
    (5, 31, 11, 5),     # widened gap
    (5, 50, 9, 1),      # C just above the detector's dc range
    (9, 12, 12, 0),     # mat900-like 9-point stencil
    (9, 7, 29, 3),
    (9, 3, 40, 0),
    (9, 25, 10, 2),
])
def test_jnp_stencil_matches_csr(points, r, c, gap, rng):
    """The jnp stencil matvec equals the CSR matvec on 5- and 9-point grids,
    including the first/last grid rows (the zero-extended ends) and the
    column seams (the gap), at any gap width."""
    a = _lap_grid(r, c) if points == 5 else _grid9(r, c)
    op = ConstStencilOperator.from_dia(a.to_dia(), dtype=jnp.float64, gap=gap)
    assert op.stride - op.c_grid >= max(gap, 1)
    x = rng.standard_normal(a.n)
    xp = op.pad_vec(x)
    yp = np.asarray(op.matvec(xp))
    np.testing.assert_allclose(np.asarray(op.unpad_vec(jnp.asarray(yp))),
                               a.matvec(x), rtol=1e-12, atol=1e-12)
    assert not yp.reshape(r, op.stride)[:, op.c_grid:].any()
