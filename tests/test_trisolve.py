"""Blocked triangular solver vs the numpy sequential oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_mat.models.problems import banded_laplacian, gen_rand_csr_matrix
from cuda_mat.ops.trisolve import BlockTriangularSolver
from cuda_mat.reference.cpu_solvers import (ilu0_factorize,
                                                solve_lower_unit, solve_upper)
from cuda_mat.formats.csr import CSRMatrix


def _check(csr, block, rng, rtol=1e-9):
    m = ilu0_factorize(csr)
    tri = BlockTriangularSolver.from_factor(csr, m, block=block)
    f = rng.standard_normal(csr.n)
    y_ref = solve_lower_unit(csr, m, f)
    x_ref = solve_upper(csr, m, y_ref)
    y = np.asarray(tri.solve_lower(jnp.asarray(f)))
    np.testing.assert_allclose(y, y_ref, rtol=rtol, atol=1e-10)
    x = np.asarray(tri.msolve(jnp.asarray(f)))
    np.testing.assert_allclose(x, x_ref, rtol=rtol, atol=1e-10)


@pytest.mark.parametrize("block", [8, 16, 64])
def test_banded_blocks(block, rng):
    _check(banded_laplacian(12), block, rng)  # n=144, offsets ±1, ±12


def test_block_not_dividing_n(rng):
    _check(banded_laplacian(11), 32, rng)  # n=121, 121 % 32 != 0


def test_block_larger_than_n(rng):
    a = gen_rand_csr_matrix(20, 20, 0.5, 1.0, 3.0, seed=5)
    d = a.to_dense() + 30 * np.eye(20)
    _check(CSRMatrix.from_dense(d), 64, rng)


def test_general_sparse(rng):
    a = gen_rand_csr_matrix(100, 100, 0.9, 0.5, 2.0, seed=9)
    d = a.to_dense() + 50 * np.eye(100)
    _check(CSRMatrix.from_dense(d), 16, rng)


def test_mat900_msolve(mat900, rng):
    _check(mat900, 64, rng)


def _setup_tri_rowloop(csr, mvals, block, lower):
    """Row-by-row reference of ``_block_setup_tri`` (its original form)."""
    n = csr.n
    nb = -(-n // block)
    diag_blocks = np.tile(np.eye(block), (nb, 1, 1))
    off_rows = [[] for _ in range(nb * block)]
    for i in range(n):
        b, ii = divmod(i, block)
        for k in range(csr.indptr[i], csr.indptr[i + 1]):
            j, v = int(csr.indices[k]), float(mvals[k])
            if (lower and j >= i) or (not lower and j < i):
                continue
            if j // block == b:
                diag_blocks[b, ii, j % block] = v
            else:
                off_rows[i].append((j, v))
    kmax = max(1, max(len(r) for r in off_rows))
    vals = np.zeros((nb, block, kmax))
    cols = np.zeros((nb, block, kmax), dtype=np.int32)
    for i, r in enumerate(off_rows):
        for k, (j, v) in enumerate(r):
            vals[i // block, i % block, k] = v
            cols[i // block, i % block, k] = j
    return np.linalg.inv(diag_blocks), vals, cols


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("case", ["mat900", "general"])
def test_block_setup_matches_row_loop(case, lower, mat900):
    """The vectorized host setup places every factor entry exactly where
    the row-by-row form does."""
    from cuda_mat.ops.trisolve import _block_setup_tri

    if case == "mat900":
        csr, block = mat900, 64
    else:
        a = gen_rand_csr_matrix(70, 70, 0.8, 0.5, 2.0, seed=4)
        csr, block = CSRMatrix.from_dense(a.to_dense() + 40 * np.eye(70)), 16
    m = ilu0_factorize(csr)
    got = _block_setup_tri(csr, m, block, lower)
    want = _setup_tri_rowloop(csr, m, block, lower)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
