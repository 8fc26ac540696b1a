"""Padded-vector solver protocol: exact ILU(0) and the split form keep the
matrix-free stencil operator (its gap-strided vectors) instead of
downgrading the matvec to the plain DIA formulation.
"""

import numpy as np
import jax.numpy as jnp

from cuda_mat.config import SolverConfig
from cuda_mat.formats.coo import COOMatrix
from cuda_mat.formats.csr import CSRMatrix
from cuda_mat.ops.stencil import ConstStencilOperator
from cuda_mat.precond.preconditioners import (ILU0Preconditioner,
                                              PaddedPreconditioner)
from cuda_mat.solvers.bicgstab import bicgstab_split, make_solver, solve


def test_padded_msolve_matches_unpadded(mat900, rng):
    """The adapter's msolve == the inner msolve, modulo exact-zero gaps."""
    pre = ILU0Preconditioner.from_csr(mat900, block=64, dtype=jnp.float64)
    pad_op = ConstStencilOperator.from_dia(mat900.to_dia(), dtype=jnp.float64)
    padded = PaddedPreconditioner(pre, pad_op)
    f = rng.standard_normal(900)
    got = padded.msolve(pad_op.pad_vec(f))
    want = np.asarray(pre.msolve(jnp.asarray(f)))
    np.testing.assert_array_equal(
        np.asarray(pad_op.unpad_vec(got)), want)
    out = np.asarray(got).reshape(30, pad_op.stride)
    assert not out[:, 30:].any()


def test_ilu0_solve_keeps_pallas_operator(mat900, rng):
    """solve(precond='ilu0') keeps the stencil operator — no operator
    downgrade — and converges like the plain DIA path, same trajectory up to
    the padded dot's rounding."""
    b = rng.uniform(1.0, 5.0, 900)
    cfg = SolverConfig(maxit=2000, tol=1e-6, precond="ilu0",
                       trisolve_block=64)
    assert isinstance(make_solver(mat900, cfg).op, ConstStencilOperator)
    plain = solve(mat900, b, cfg, format="dia")
    pad = solve(mat900, b, cfg, format="stencil")
    assert pad.converged and plain.converged
    assert abs(pad.iters - plain.iters) <= 1
    rel = np.linalg.norm(b - mat900.matvec(pad.x)) / np.linalg.norm(b)
    assert rel < 1e-5
    np.testing.assert_allclose(pad.x, plain.x, rtol=1e-6, atol=1e-9)


def _drop_diagonal(csr: CSRMatrix) -> CSRMatrix:
    coo = csr.to_coo()
    off = coo.rows != coo.cols
    return CSRMatrix.from_coo(COOMatrix(csr.n, csr.m, coo.rows[off],
                                        coo.cols[off], coo.data[off]))


def test_split_solve_padded_matches_unpadded(mat900, rng):
    """bicgstab_split over the stencil operator (A = A0 + diag(d),
    reference pbicgstab.cu:926-1088) == the plain-format solve."""
    d = mat900.diagonal()
    a0 = _drop_diagonal(mat900)
    b = rng.uniform(1.0, 5.0, 900)
    x0 = np.ones(900)
    cfg = SolverConfig(maxit=2000, tol=1e-6)
    plain = bicgstab_split(a0, d, x0, b, cfg, format="dia")
    pad = bicgstab_split(a0, d, x0, b, cfg, format="stencil")
    assert pad.converged and plain.converged
    # ~45 unpreconditioned iterations: the padded dot's different summation
    # order shifts the late trajectory by a couple of iterations (same fp
    # chaos as the mat10000 oracle, see test_goldens) — the solution is the
    # real invariant
    assert abs(pad.iters - plain.iters) <= 5
    rel = np.linalg.norm(b - mat900.matvec(pad.x)) / np.linalg.norm(b)
    assert rel < 1e-5
