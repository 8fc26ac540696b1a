"""Device operator tests: every SpMV formulation vs the numpy oracle
(SURVEY §4 implication 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_mat.formats.csr import CSRMatrix
from cuda_mat.models.problems import banded_laplacian, gen_rand_csr_matrix
from cuda_mat.ops.operators import (CSROperator, DIAOperator, DenseOperator,
                                        ELLOperator, SplitOperator,
                                        make_operator)


@pytest.fixture(scope="module")
def rand_csr():
    return gen_rand_csr_matrix(60, 60, probability_of_zero=0.85, vmin=-3.0,
                               vmax=3.0, seed=11)


@pytest.mark.parametrize("fmt", ["csr", "ell", "dense"])
def test_spmv_formats_random(rand_csr, fmt, rng):
    op = make_operator(rand_csr, dtype=jnp.float64, format=fmt)
    x = rng.standard_normal(60)
    y = jax.jit(lambda o, xx: o.matvec(xx))(op, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), rand_csr.matvec(x), rtol=1e-13, atol=1e-12)


@pytest.mark.parametrize("fmt", ["csr", "ell", "dia", "dense"])
def test_spmv_formats_banded(fmt, rng):
    a = banded_laplacian(12)
    op = make_operator(a, dtype=jnp.float64, format=fmt)
    x = rng.standard_normal(144)
    y = jax.jit(lambda o, xx: o.matvec(xx))(op, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), a.matvec(x), rtol=1e-13, atol=1e-12)


def test_auto_format_selection(rand_csr, mat10000):
    assert isinstance(make_operator(mat10000), DIAOperator)
    op = make_operator(rand_csr)
    assert isinstance(op, (ELLOperator, CSROperator))


def test_split_operator(mat3, mat3_a0, vec3_d, rng):
    base = make_operator(mat3_a0, format="csr")
    op = SplitOperator(base, jnp.asarray(vec3_d))
    x = rng.standard_normal(3)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               mat3.matvec(x), rtol=1e-13, atol=1e-12)


def test_operators_are_pytrees(rand_csr):
    op = make_operator(rand_csr, format="ell")
    leaves = jax.tree_util.tree_leaves(op)
    assert len(leaves) == 2
    # jit must treat the operator as an argument without error
    f = jax.jit(lambda o: o.matvec(jnp.ones(60)))
    f(op)


def test_mat10000_spmv(mat10000, rng):
    x = rng.standard_normal(10000)
    for fmt in ("dia", "ell", "csr"):
        op = make_operator(mat10000, format=fmt)
        y = np.asarray(op.matvec(jnp.asarray(x)))
        np.testing.assert_allclose(y, mat10000.matvec(x), rtol=1e-12)


def test_bell_operator_matches_csr(rng):
    """Blocked-ELL (BSR-padded) matvec == scalar CSR matvec on an
    unstructured random matrix (incl. n not a multiple of the block)."""
    import jax.numpy as jnp
    import numpy as np
    from cuda_mat.models.problems import random_diag_nonzero_system
    from cuda_mat.ops.operators import BELLOperator

    a, _ = random_diag_nonzero_system(300, prob_of_zero=0.97, seed=7)
    op = BELLOperator.from_csr(a, bs=64, dtype=jnp.float64)
    x = rng.standard_normal(a.n)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               a.matvec(x), rtol=1e-10, atol=1e-10)


def test_bell_block_structured_solve(rng):
    """Block-diagonal-dominant system through the generic solver with the
    BELL operator format."""
    import numpy as np
    from cuda_mat.config import SolverConfig
    from cuda_mat.formats.csr import CSRMatrix
    from cuda_mat.solvers.bicgstab import bicgstab

    n, bs = 256, 32
    d = np.zeros((n, n))
    for i in range(0, n, bs):
        blk = rng.standard_normal((bs, bs)) * 0.1
        d[i:i + bs, i:i + bs] = blk + np.eye(bs) * 4
    a = CSRMatrix.from_dense(d)
    b = rng.uniform(1.0, 5.0, n)
    res = bicgstab(a, b, SolverConfig(maxit=500, tol=1e-10), format="bell")
    assert res.converged
    assert np.linalg.norm(b - a.matvec(res.x)) / np.linalg.norm(b) < 1e-8


@pytest.mark.parametrize("n,m,offsets", [
    (50, 50, (0,)),
    (50, 50, (-1, 0, 1)),
    (64, 64, (-8, -1, 0, 1, 8)),
    (40, 40, (-39, 0, 39)),          # corner-only diagonals
    (30, 45, (0, 3, 14)),            # wide: columns past the last row
    (45, 30, (-14, -2, 0)),          # tall: rows past the last column
    (37, 37, (2, 5)),                # no main diagonal, upper only
    (33, 20, (-30, -7, 4, 19)),      # tall, offsets on both sides
])
def test_dia_single_pass_matches_host_f64(n, m, offsets, rng):
    """DIAOperator.matvec — one sum of shifted slices of the zero-extended x
    — equals the host float64 CSR product over offsets and (rectangular)
    shapes, including diagonals that run off either edge."""
    from cuda_mat.formats.coo import COOMatrix

    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, m - off))
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    a = CSRMatrix.from_coo(COOMatrix(n, m, rows, cols,
                                     rng.uniform(-2.0, 2.0, rows.shape[0])))
    op = make_operator(a, dtype=jnp.float64, format="dia")
    assert isinstance(op, DIAOperator)
    x = rng.standard_normal(m)
    y = jax.jit(lambda o, xx: o.matvec(xx))(op, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), a.matvec(x), rtol=1e-13,
                               atol=1e-13)
