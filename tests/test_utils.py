"""Utility-layer tests: inf-norms (C10), checkpointing, dense Givens-QR (C15),
phase timer."""

import numpy as np
import pytest

from cuda_mat.utils.norms import csr_mat_norminf, mat_norminf, vec_norminf
from cuda_mat.utils.checkpoint import load_checkpoint, save_checkpoint
from cuda_mat.utils.dense_qr import (back_substitution, is_consistent,
                                         qr_givens, rank_row_echelon,
                                         solve_qr)
from cuda_mat.utils.timing import PhaseTimer


def test_norms(mat3, rng):
    v = rng.standard_normal(10)
    assert vec_norminf(v) == np.abs(v).max()
    d = mat3.to_dense()
    assert mat_norminf(d) == np.abs(d).sum(axis=1).max()
    assert csr_mat_norminf(mat3) == mat_norminf(d)
    assert vec_norminf([]) == 0.0


def test_checkpoint_roundtrip(tmp_path, mat900, rng):
    from cuda_mat.config import SolverConfig
    from cuda_mat.solvers.bicgstab import bicgstab

    b = rng.uniform(1.0, 5.0, 900)
    res = bicgstab(mat900, b, SolverConfig(maxit=5, tol=1e-14))
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, res, matrix="mat900")
    ck = load_checkpoint(p)
    np.testing.assert_array_equal(ck.x, res.x)
    assert ck.iters == res.iters
    assert str(ck.meta["matrix"]) == "mat900"


def test_checkpoint_resume_converges(tmp_path, mat900, rng):
    """Restarting from a checkpointed iterate continues to convergence."""
    from cuda_mat.config import SolverConfig
    from cuda_mat.solvers.bicgstab import bicgstab

    b = rng.uniform(1.0, 5.0, 900)
    partial = bicgstab(mat900, b, SolverConfig(maxit=10, tol=1e-14))
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, partial)
    ck = load_checkpoint(p)
    res = bicgstab(mat900, b, SolverConfig(maxit=2000, tol=1e-6), x0=ck.x)
    assert res.converged
    r = np.linalg.norm(b - mat900.matvec(res.x)) / np.linalg.norm(b)
    assert r < 1e-5


def test_qr_givens(rng):
    a = rng.standard_normal((6, 6))
    q, r = qr_givens(a)
    np.testing.assert_allclose(q @ r, a, atol=1e-10)
    np.testing.assert_allclose(q @ q.T, np.eye(6), atol=1e-10)
    np.testing.assert_allclose(np.tril(r, -1), 0.0, atol=1e-10)


def test_rank_and_consistency():
    a = np.array([[1.0, 2.0], [2.0, 4.0]])  # rank 1
    assert rank_row_echelon(a) == 1
    assert is_consistent(a, np.array([1.0, 2.0]))       # b in range
    assert not is_consistent(a, np.array([1.0, 3.0]))   # b not in range


def test_back_substitution(rng):
    r = np.triu(rng.standard_normal((5, 5))) + 5 * np.eye(5)
    y = rng.standard_normal(5)
    np.testing.assert_allclose(r @ back_substitution(r, y), y, atol=1e-10)


def test_solve_qr(rng):
    a = rng.standard_normal((5, 5)) + 5 * np.eye(5)
    b = rng.standard_normal(5)
    x = solve_qr(a, b)
    np.testing.assert_allclose(a @ x, b, atol=1e-9)
    assert solve_qr(np.array([[1.0, 2.0], [2.0, 4.0]]),
                    np.array([1.0, 3.0])) is None


def test_phase_timer():
    import time

    t = PhaseTimer()
    with t.phase("load"):
        time.sleep(0.01)
    assert t.times["load"] >= 0.01
    assert "load" in t.report()
