"""PreparedSolver (setup-once / solve-many) tests.

The prepared single-chip solver must be trajectory-identical to the one-shot
``solve`` path, reuse its setup across right-hand sides (``solve_refined``
must factorize ILU(0) exactly once), and the distributed refinement path
must meet the same reference tolerance (example.cpp:179-180) as the
single-chip one.
"""

import numpy as np
import pytest

from cuda_mat.config import SolverConfig
from cuda_mat.solvers.bicgstab import bicgstab, make_solver, solve
from cuda_mat.solvers.refine import solve_refined


CFG_ILU = SolverConfig(maxit=2000, tol=1e-6, precond="ilu0")


def test_prepared_matches_oneshot_trajectory(mat900):
    b = np.ones(mat900.n)
    one = solve(mat900, b, CFG_ILU)
    ps = make_solver(mat900, CFG_ILU)
    r1 = ps.solve(b)
    r2 = ps.solve(b)
    for r in (r1, r2):
        assert r.iters == one.iters
        assert r.status == one.status
        np.testing.assert_array_equal(r.trajectory(), one.trajectory())
        np.testing.assert_array_equal(r.x, one.x)


def test_prepared_many_rhs(mat900, rng):
    ps = make_solver(mat900, CFG_ILU)
    for _ in range(3):
        x_true = rng.standard_normal(mat900.n)
        b = mat900.matvec(x_true)
        res = ps.solve(b)
        assert res.converged
        assert np.linalg.norm(res.x - x_true) < 1e-3 * np.linalg.norm(x_true)


def test_prepared_hform_matches_bicgstab(mat3, vec3):
    cfg = SolverConfig(maxit=200, tol=1e-5, precond="none")
    one = bicgstab(mat3, vec3, cfg)
    ps = make_solver(mat3, cfg)
    r = ps.solve(vec3)
    assert r.iters == one.iters
    np.testing.assert_array_equal(r.trajectory(), one.trajectory())
    np.testing.assert_array_equal(r.x, one.x)


def test_prepared_rcm_scatters_back(mat900):
    cfg = CFG_ILU.replace(reorder="rcm")
    ps = make_solver(mat900, cfg)
    b = np.ones(mat900.n)
    res = ps.solve(b)
    one = solve(mat900, b, cfg)
    assert res.converged
    np.testing.assert_array_equal(res.x, one.x)
    # true residual is computed against the ORIGINAL ordering
    rel = res.residual_true / res.residual0
    assert rel < 1e-5


def test_prepared_x0_default_is_ones(mat900):
    """x0 defaults to all-ones (reference pbicgstab.cu:306-308)."""
    ps = make_solver(mat900, CFG_ILU)
    b = np.ones(mat900.n)
    np.testing.assert_array_equal(ps.solve(b).x,
                                  ps.solve(b, x0=np.ones(mat900.n)).x)


def test_refined_factorizes_once(mat900, monkeypatch):
    """solve_refined builds ONE PreparedSolver: the ILU(0) factorization must
    run exactly once across all restarts (it used to
    re-factorize per restart)."""
    import cuda_mat.precond.preconditioners as P

    calls = {"n": 0}
    real = P._factorize

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(P, "_factorize", counting)
    b = np.ones(mat900.n)
    res = solve_refined(mat900, b, CFG_ILU.replace(tol=1e-10),
                        inner_tol=1e-2)
    assert res.converged
    assert len(res.residual_history) > 2       # multiple restarts happened
    assert calls["n"] == 1


def test_refined_distributed_meets_reference_tol(mat10000):
    """Distributed iterative refinement: f32 inner
    solves through the compiled DistBicgstabSolver + f64 host restarts reach
    the reference contract tol=1e-6 (example.cpp:179-180), and agree with
    the single-chip refined result."""
    from cuda_mat.parallel.mesh import make_mesh

    cfg = SolverConfig(maxit=2000, tol=1e-6, precond="ilu0_neumann",
                       neumann_terms=3)
    b = np.ones(mat10000.n)
    single = solve_refined(mat10000, b, cfg, inner_tol=1e-2)
    dist = solve_refined(mat10000, b, cfg, inner_tol=1e-2,
                         mesh=make_mesh(4))
    assert single.converged and dist.converged
    for r in (single, dist):
        assert r.residual_true / r.residual0 < 1e-6
    # both refined to the same f64 contract -> same solution to ~tol
    err = (np.linalg.norm(dist.x - single.x)
           / np.linalg.norm(single.x))
    assert err < 1e-5


def test_cli_devices_refine_combination(capsys):
    """--devices N --refine runs distributed refinement (used to silently
    drop --refine)."""
    from cuda_mat.cli import main
    from cuda_mat.models.problems import fixture_path

    rc = main(["-M", fixture_path("mat900"), "--devices", "2",
               "--precond", "jacobi", "--refine", "--tol", "1e-8"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "success" in out
    assert "true relative residual" in out


def test_cli_bicg_refine_errors_loudly(capsys):
    from cuda_mat.cli import main
    from cuda_mat.models.problems import fixture_path

    rc = main(["-M", fixture_path("mat900"), "--solver", "bicg", "--refine"])
    assert rc == 1
    assert "bicg" in capsys.readouterr().err


def test_cli_bicg_devices_errors_loudly(capsys):
    from cuda_mat.cli import main
    from cuda_mat.models.problems import fixture_path

    rc = main(["-M", fixture_path("mat900"), "--solver", "bicg",
               "--devices", "2"])
    assert rc == 1
    assert "bicg" in capsys.readouterr().err


def test_refined_stops_on_diverging_correction(mat900):
    """A diverging inner solver (garbage corrections) must not burn all
    max_restarts: solve_refined reverts the worsening correction and stops
    with an honest non-converged status (r5 divergence guard)."""
    from cuda_mat.solvers.result import SolveResult, SolverStatus

    calls = {"n": 0}

    class GarbageSolver:
        def solve(self, r, x0=None):
            calls["n"] += 1
            rng = np.random.default_rng(calls["n"])
            # finite but wrong and growing: each "correction" increases
            # the true residual
            return SolveResult(
                x=rng.standard_normal(mat900.n) * 10.0**calls["n"],
                status=SolverStatus.MAXIT, iters=5, residual=1.0,
                residual0=1.0, dt_alg=0.0)

    b = np.ones(mat900.n)
    res = solve_refined(mat900, b, CFG_ILU.replace(tol=1e-12),
                        max_restarts=20, solver=GarbageSolver())
    assert not res.converged
    assert calls["n"] <= 2                 # stopped after the first increase
    assert np.isfinite(res.x).all()
    # the returned x is the PRE-divergence iterate, and the reported
    # residual matches it
    rel = np.linalg.norm(b - mat900.matvec(res.x)) / res.residual0
    np.testing.assert_allclose(res.residual / res.residual0, rel, rtol=1e-12)


def test_refined_distributed_stencil_milu():
    """The bench's distributed production path as one CI combination:
    gap-strided stencil engine + MILU(0.96) factors + iterative refinement
    over the virtual mesh."""
    from cuda_mat.models.problems import grid_laplacian
    from cuda_mat.parallel.mesh import make_mesh

    a = grid_laplacian(8, 126)          # 1008 rows, constant 5-pt stencil
    b = np.ones(a.n)
    cfg = SolverConfig(maxit=2000, tol=1e-10, dtype="float32",
                       precond="ilu0_neumann", neumann_terms=3,
                       milu_omega=0.96)
    res = solve_refined(a, b, cfg, inner_tol=1e-3, mesh=make_mesh(4),
                        local_engine="stencil")
    assert res.converged
    assert res.residual_true / res.residual0 < 1e-10
    x64 = np.linalg.solve(a.to_dense(), b)
    np.testing.assert_allclose(res.x, x64, rtol=1e-8, atol=1e-8)
