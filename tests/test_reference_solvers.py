"""Numpy reference (oracle) solver tests: they must actually solve the
reference fixtures at the reference tolerances (SURVEY §4 implication 2/3)."""

import numpy as np
import pytest

from cuda_mat.reference.cpu_solvers import (bicg_cpu, bicgstab_hform_cpu,
                                                bicgstab_ilu_cpu,
                                                bicgstab_split_cpu,
                                                ilu0_factorize,
                                                solve_lower_unit, solve_upper)
from cuda_mat.models.problems import laplacian_2d


def _residual(a, x, b):
    return np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b)


def test_bicg_mat3(mat3, vec3):
    res = bicg_cpu(mat3, vec3, maxit=2000, eps=1e-6)
    assert res.converged
    assert _residual(mat3, res.x, vec3) < 1e-4
    # true solution of [[1,2,3],[5,0,1],[1,1,1]] x = [1,2,3]
    np.testing.assert_allclose(mat3.to_dense() @ res.x, vec3, atol=1e-4)


def test_bicgstab_hform_mat3(mat3, vec3):
    res = bicgstab_hform_cpu(mat3, vec3, maxit=2000, tol=1e-6)
    assert res.converged and not res.breakdown
    assert _residual(mat3, res.x, vec3) < 1e-5


def test_bicgstab_split_mat3(mat3, mat3_a0, vec3_d, vec3):
    """The demo path test_A0_d (reference example.cpp:33-106): maxit=2000,
    tol=1e-5, x0=ones."""
    res = bicgstab_split_cpu(mat3_a0, vec3_d, np.ones(3), vec3, maxit=2000,
                             tol=1e-5)
    assert res.converged
    np.testing.assert_allclose(mat3.to_dense() @ res.x, vec3, atol=1e-4)


def test_split_equals_plain_trajectory(mat3, mat3_a0, vec3_d, vec3):
    """Split-form and plain h-form must produce identical trajectories when
    given the same x0 (the fused SpMV is algebraically the same matrix)."""
    r1 = bicgstab_hform_cpu(mat3, vec3, maxit=50, tol=1e-12, x0=np.ones(3))
    r2 = bicgstab_split_cpu(mat3_a0, vec3_d, np.ones(3), vec3, maxit=50,
                            tol=1e-12)
    n = min(len(r1.residual_history), len(r2.residual_history))
    np.testing.assert_allclose(r1.residual_history[:n],
                               r2.residual_history[:n], rtol=1e-9, atol=1e-10)


def test_ilu0_exact_lu_on_dense_pattern():
    """On a fully dense pattern ILU(0) == exact LU."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((6, 6)) + 6 * np.eye(6)
    from cuda_mat.formats.csr import CSRMatrix

    a = CSRMatrix.from_dense(d, eps=-1.0)  # keep all entries incl. zeros
    m = ilu0_factorize(a)
    md = a.to_dense() * 0
    for i in range(6):
        lo, hi = a.indptr[i], a.indptr[i + 1]
        md[i, a.indices[lo:hi]] = m[lo:hi]
    l = np.tril(md, -1) + np.eye(6)
    u = np.triu(md)
    np.testing.assert_allclose(l @ u, d, rtol=1e-10, atol=1e-12)


def test_ilu0_triangular_solves(mat900, rng):
    m = ilu0_factorize(mat900)
    b = rng.standard_normal(900)
    y = solve_lower_unit(mat900, m, b)
    x = solve_upper(mat900, m, y)
    # rebuild dense L, U and check
    md = np.zeros((900, 900))
    for i in range(900):
        lo, hi = mat900.indptr[i], mat900.indptr[i + 1]
        md[i, mat900.indices[lo:hi]] = m[lo:hi]
    l = np.tril(md, -1) + np.eye(900)
    u = np.triu(md)
    np.testing.assert_allclose(l @ y, b, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(u @ x, y, rtol=1e-8, atol=1e-10)


def test_ilu0_requires_diagonal():
    from cuda_mat.formats.csr import CSRMatrix

    a = CSRMatrix.from_dense(np.array([[0.0, 1.0], [1.0, 0.0]]))
    with pytest.raises(ValueError):
        ilu0_factorize(a)


def test_bicgstab_ilu_mat3_violates_contract(mat3, vec3):
    """mat3 has a structural zero at (1,1), violating the reference's ILU
    contract "for i = j must hold: A[i,j] != 0" (reference pbicgstab.h:118) —
    the reference's dead demo test1 would hit undefined cusparse behavior; we
    raise instead."""
    with pytest.raises(ValueError):
        bicgstab_ilu_cpu(mat3, vec3, maxit=200, tol=1e-5)


def test_bicgstab_ilu_small_dense_pattern(rng):
    from cuda_mat.formats.csr import CSRMatrix

    d = rng.standard_normal((8, 8)) + 8 * np.eye(8)
    a = CSRMatrix.from_dense(d, eps=-1.0)
    b = rng.uniform(1.0, 5.0, 8)
    res = bicgstab_ilu_cpu(a, b, maxit=200, tol=1e-8)
    assert res.converged
    # dense-pattern ILU(0) is an exact LU: convergence in one iteration
    assert res.iters <= 1
    np.testing.assert_allclose(d @ res.x, b, rtol=1e-6)


def test_bicgstab_ilu_mat900(mat900, rng):
    b = rng.uniform(1.0, 5.0, 900)
    res = bicgstab_ilu_cpu(mat900, b, maxit=2000, tol=1e-6)
    assert res.converged
    assert res.iters < 100  # ILU(0) should converge fast on the Laplacian
    assert _residual(mat900, res.x, b) < 1e-5


def test_bicgstab_hform_mat900(mat900, rng):
    b = rng.uniform(1.0, 5.0, 900)
    res = bicgstab_hform_cpu(mat900, b, maxit=2000, tol=1e-6)
    assert res.converged
    assert _residual(mat900, res.x, b) < 1e-5


def test_bicg_matches_omp_semantics_small():
    """x is not updated on the converged iteration (reference
    bicstab.cpp:164-168): starting at the exact solution, x stays exactly the
    initial guess."""
    from cuda_mat.formats.csr import CSRMatrix

    a = CSRMatrix.from_dense(np.eye(4) * 2.0)
    b = np.full(4, 2.0)  # solution = ones = x0
    res = bicg_cpu(a, b, maxit=10, eps=1e-6)
    assert res.converged
    np.testing.assert_array_equal(res.x, np.ones(4))
    assert res.iters == 0
