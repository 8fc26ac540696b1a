"""Checked-in trajectory goldens (SURVEY §4 / ROADMAP).

Two layers of pinning:

1. Oracle stability — regenerating each oracle trajectory must match the
   checked-in golden *bitwise* (same machine ops in the same order; guards
   the numpy oracles in reference/cpu_solvers.py against accidental edits).
2. Solver parity — the jitted f64 solvers must reproduce the golden
   iteration count and solution (the reference-trajectory criterion of
   BASELINE.md).

Regenerate with ``python tests/make_goldens.py`` after an *intentional*
oracle change.
"""

import os

import numpy as np
import pytest

from cuda_mat.config import SolverConfig
from cuda_mat.reference.cpu_solvers import (bicg_cpu, bicgstab_hform_cpu,
                                                bicgstab_ilu_cpu,
                                                bicgstab_split_cpu)
from cuda_mat.solvers.bicgstab import bicgstab, bicgstab_lu_precond

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _load(name):
    return np.load(os.path.join(GOLDENS, f"{name}.npz"))


def _assert_bitwise(r, g):
    assert int(r.iters) == int(g["iters"])
    assert bool(r.converged) == bool(g["converged"])
    np.testing.assert_array_equal(np.asarray(r.residual_history,
                                             dtype=np.float64), g["history"])
    np.testing.assert_array_equal(np.asarray(r.x, dtype=np.float64), g["x"])


def test_oracle_mat3_hform_bitwise(mat3, vec3):
    _assert_bitwise(bicgstab_hform_cpu(mat3, vec3, maxit=200, tol=1e-5),
                    _load("mat3_hform"))


def test_oracle_mat3_split_bitwise(mat3_a0, vec3_d, vec3):
    _assert_bitwise(
        bicgstab_split_cpu(mat3_a0, vec3_d, np.ones(3), vec3, maxit=2000,
                           tol=1e-5), _load("mat3_split"))


def test_oracle_mat900_ilu_bitwise(mat900):
    _assert_bitwise(bicgstab_ilu_cpu(mat900, np.ones(900)),
                    _load("mat900_ilu"))


def test_oracle_mat900_hform_bitwise(mat900):
    _assert_bitwise(bicgstab_hform_cpu(mat900, np.ones(900)),
                    _load("mat900_hform"))


def test_oracle_mat900_bicg_bitwise(mat900):
    _assert_bitwise(bicg_cpu(mat900, np.ones(900)), _load("mat900_bicg"))


def test_oracle_mat10000_ilu_bitwise(mat10000):
    _assert_bitwise(bicgstab_ilu_cpu(mat10000, np.ones(10000)),
                    _load("mat10000_ilu"))


def test_solver_matches_golden_mat3(mat3, vec3):
    g = _load("mat3_hform")
    r = bicgstab(mat3, vec3, SolverConfig(maxit=200, tol=1e-5))
    assert r.converged and r.iters == int(g["iters"])
    np.testing.assert_allclose(r.x, g["x"], rtol=1e-10, atol=1e-12)
    # reference demo anchor: x = [7/6, 17/3, -23/6]
    np.testing.assert_allclose(r.x, [7 / 6, 17 / 3, -23 / 6], rtol=1e-9)


def test_solver_matches_golden_mat900_ilu(mat900):
    g = _load("mat900_ilu")
    r = bicgstab_lu_precond(mat900, np.ones(900),
                            SolverConfig(maxit=2000, tol=1e-6))
    assert r.converged
    assert abs(r.iters - int(g["iters"])) <= 2  # f64 jit vs numpy fp order
    np.testing.assert_allclose(r.x, g["x"], rtol=1e-5, atol=1e-7)


# --- remaining entry points on the headline fixture -------------------------

def test_oracle_mat10000_hform_bitwise(mat10000):
    _assert_bitwise(bicgstab_hform_cpu(mat10000, np.ones(10000)),
                    _load("mat10000_hform"))


def test_oracle_mat10000_split_bitwise(mat10000):
    from cuda_mat.models.problems import split_form

    a0, d = split_form(mat10000)
    _assert_bitwise(
        bicgstab_split_cpu(a0, d, np.ones(10000), np.ones(10000),
                           maxit=2000, tol=1e-6), _load("mat10000_split"))


def test_oracle_mat10000_bicg_bitwise(mat10000):
    _assert_bitwise(bicg_cpu(mat10000, np.ones(10000)),
                    _load("mat10000_bicg"))


def test_solver_matches_golden_mat10000_hform(mat10000):
    g = _load("mat10000_hform")
    r = bicgstab(mat10000, np.ones(10000), SolverConfig(maxit=2000, tol=1e-6))
    assert r.converged
    assert abs(r.iters - int(g["iters"])) <= 6  # late-trajectory fp chaos
    rel = np.linalg.norm(np.ones(10000) - mat10000.matvec(r.x)) \
        / np.sqrt(10000.0)
    assert rel < 1e-5


def test_solver_matches_golden_mat10000_split(mat10000):
    from cuda_mat.models.problems import split_form
    from cuda_mat.solvers.bicgstab import bicgstab_split

    a0, d = split_form(mat10000)
    g = _load("mat10000_split")
    r = bicgstab_split(a0, d, np.ones(10000), np.ones(10000),
                       SolverConfig(maxit=2000, tol=1e-6))
    assert r.converged
    assert abs(r.iters - int(g["iters"])) <= 6
    rel = np.linalg.norm(np.ones(10000) - mat10000.matvec(r.x)) \
        / np.sqrt(10000.0)
    assert rel < 1e-5


def test_solver_matches_golden_mat10000_bicg(mat10000):
    from cuda_mat.solvers.bicg import bicg

    g = _load("mat10000_bicg")
    r = bicg(mat10000, np.ones(10000), SolverConfig(maxit=2000, tol=1e-6))
    assert r.converged
    assert abs(r.iters - int(g["iters"])) <= 6
    np.testing.assert_allclose(r.x, g["x"], rtol=1e-4, atol=1e-6)


# --- f32 iteration-count band ----------------------------------------------
# These pin the f32 *behavior* of the jitted code on the CI backend:
# convergence at the reference tolerance with an iteration count inside a
# band around the f64 golden.

def test_f32_band_mat10000_ilu(mat10000):
    g = _load("mat10000_ilu")
    r = bicgstab_lu_precond(mat10000, np.ones(10000),
                            SolverConfig(maxit=2000, tol=1e-6,
                                         dtype="float32",
                                         trisolve_block=128))
    assert r.converged
    assert abs(r.iters - int(g["iters"])) <= 15
    # true-residual check: the f32 *recursive* residual drifts ~2-3 decades
    # from the true residual at n=1e4 (sqrt(n)*eps accumulation;
    # solve_refined exists to close the gap).  SolveResult carries the f64
    # host recomputation as residual_true: assert on the library surface,
    # then cross-check.
    assert r.residual_true is not None
    assert r.residual_true / np.sqrt(10000.0) < 1e-3
    rel = np.linalg.norm(np.ones(10000) - mat10000.matvec(
        r.x.astype(np.float64)))
    np.testing.assert_allclose(r.residual_true, rel, rtol=1e-10)


def test_f32_band_mat900_ilu(mat900):
    g = _load("mat900_ilu")
    r = bicgstab_lu_precond(mat900, np.ones(900),
                            SolverConfig(maxit=2000, tol=1e-6,
                                         dtype="float32",
                                         trisolve_block=128))
    assert r.converged
    assert abs(r.iters - int(g["iters"])) <= 10


# --- relaxed-MILU trajectory golden -----------------------------------------

def test_oracle_mat900_milu_bitwise(mat900):
    from cuda_mat.precond.preconditioners import milu0_factorize

    _assert_bitwise(
        bicgstab_ilu_cpu(mat900, np.ones(900),
                         mvals=milu0_factorize(mat900, 0.97)),
        _load("mat900_milu097"))


def test_solver_matches_golden_mat900_milu(mat900):
    from cuda_mat.solvers.bicgstab import solve

    g = _load("mat900_milu097")
    r = solve(mat900, np.ones(900),
              SolverConfig(maxit=2000, tol=1e-6, precond="ilu0",
                           milu_omega=0.97))
    assert r.converged
    assert abs(r.iters - int(g["iters"])) <= 2  # f64 jit vs numpy fp order
    np.testing.assert_allclose(r.x, g["x"], rtol=1e-5, atol=1e-7)
    # the golden also pins the MILU *benefit*: fewer iterations than the
    # plain-ILU golden on the same fixture
    assert int(g["iters"]) < int(_load("mat900_ilu")["iters"])
