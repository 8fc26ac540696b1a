"""Property-style tests: random systems solved by every path must agree with
scipy's direct sparse solve (SURVEY §4 implication 5)."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from cuda_mat.config import SolverConfig
from cuda_mat.formats.csr import CSRMatrix
from cuda_mat.models.problems import banded_laplacian
from cuda_mat.solvers.bicg import bicg
from cuda_mat.solvers.bicgstab import bicgstab, solve


def _scipy_solve(a: CSRMatrix, b):
    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(a.n, a.m))
    return spla.spsolve(m, b)


def _random_dd_system(n, density, seed):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((n, n)) < density, rng.standard_normal((n, n)), 0.0)
    np.fill_diagonal(d, 0.0)
    d += np.diag(np.abs(d).sum(axis=1) + rng.uniform(1.0, 2.0, n))
    return CSRMatrix.from_dense(d), rng.uniform(-1.0, 1.0, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("precond", ["none", "jacobi", "ilu0"])
def test_random_dd_matches_scipy(seed, precond):
    a, b = _random_dd_system(80, 0.08, seed)
    cfg = SolverConfig(maxit=2000, tol=1e-10, precond=precond,
                       trisolve_block=32)
    res = solve(a, b, cfg)
    assert res.converged, (seed, precond)
    np.testing.assert_allclose(res.x, _scipy_solve(a, b), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("seed", [3, 4])
def test_random_dd_bicg_matches_scipy(seed):
    a, b = _random_dd_system(60, 0.1, seed)
    res = bicg(a, b, SolverConfig(maxit=2000, tol=1e-10))
    assert res.converged
    np.testing.assert_allclose(res.x, _scipy_solve(a, b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("side", [9, 16])
def test_laplacian_matches_scipy(side):
    a = banded_laplacian(side)
    rng = np.random.default_rng(side)
    b = rng.uniform(1.0, 5.0, a.n)
    res = bicgstab(a, b, SolverConfig(maxit=2000, tol=1e-10))
    assert res.converged
    np.testing.assert_allclose(res.x, _scipy_solve(a, b), rtol=1e-6, atol=1e-8)


def test_ilu0_defining_property(mat900):
    """ILU(0) definition: (L·U) agrees with A exactly on A's sparsity pattern
    (scipy's spilu is threshold-based ILUTP and is NOT a valid oracle for
    pattern-based ILU(0))."""
    from cuda_mat.reference.cpu_solvers import ilu0_factorize

    m = ilu0_factorize(mat900)
    md = np.zeros((900, 900))
    for i in range(900):
        lo, hi = mat900.indptr[i], mat900.indptr[i + 1]
        md[i, mat900.indices[lo:hi]] = m[lo:hi]
    l = np.tril(md, -1) + np.eye(900)
    u = np.triu(md)
    lu = l @ u
    ad = mat900.to_dense()
    pattern = ad != 0
    np.testing.assert_allclose(lu[pattern], ad[pattern], rtol=1e-10,
                               atol=1e-12)
