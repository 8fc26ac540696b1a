"""check_halves=False (first-half convergence-check elision).

The reference tests convergence after each half-iteration (reference
pbicgstab.cu:116,147).  ``check_halves=False`` tests only after full
iterations: every pre-exit iteration is BITWISE identical (the elided
selects were no-ops while conv1 was false) and the exit differs only when
the reference run would have stopped on a first half-step — then the
elided run completes that iteration (one extra half, smaller residual).
"""

import jax
import jax.numpy as jnp
import numpy as np

from cuda_mat.config import SolverConfig
from cuda_mat.solvers.bicgstab import make_solver, solve

CFG = SolverConfig(maxit=2000, tol=1e-6, precond="ilu0")


def _full_iter_residuals(res):
    """Second-half (full-iteration) residual entries of the history."""
    h = np.asarray(res.residual_history)
    return h[1::2][h[1::2] >= 0]


def test_check_halves_off_same_trajectory(mat900):
    b = np.ones(mat900.n)
    r_on = solve(mat900, b, CFG)
    r_off = solve(mat900, b, CFG.replace(check_halves=False))
    assert r_on.converged and r_off.converged
    # pre-exit full iterations are bitwise identical
    f_on, f_off = _full_iter_residuals(r_on), _full_iter_residuals(r_off)
    m = min(len(f_on), len(f_off))
    np.testing.assert_array_equal(f_on[:m], f_off[:m])
    # exit may differ by at most the completed half-iteration
    assert 0 <= r_off.iters - r_on.iters <= 1
    np.testing.assert_allclose(r_off.x, r_on.x, rtol=1e-8, atol=1e-10)


def test_check_halves_off_first_half_exit(mat10000):
    """mat10000/ILU exits on a FIRST half-step (the history's last entry sits
    in an even slot) — the elided run must complete the iteration instead,
    with a residual at least as small."""
    b = np.ones(mat10000.n)
    r_on = solve(mat10000, b, CFG)
    h_on = np.asarray(r_on.residual_history)
    used = np.flatnonzero(h_on >= 0)
    first_half_exit = bool(used[-1] % 2 == 0)
    r_off = solve(mat10000, b, CFG.replace(check_halves=False))
    assert r_on.converged and r_off.converged
    if first_half_exit:
        assert r_off.iters == r_on.iters + 1
        assert r_off.residual <= r_on.residual * (1 + 1e-12)
    else:
        assert r_off.iters == r_on.iters
        np.testing.assert_array_equal(r_off.x, r_on.x)


def test_check_halves_off_smaller_graph(mat900):
    """Graph-level engagement proof: the two configs must LOWER to
    different programs, the elided one with fewer
    select/compare nodes — a silently-ungated flag would lower identically
    and any measured 'win' would be noise."""
    from cuda_mat.solvers.bicgstab import _precond_solve

    ps = make_solver(mat900, CFG)
    b = ps._prep_vec(np.ones(mat900.n))
    x0 = ps._prep_vec(np.ones(mat900.n))
    tol = jnp.asarray(1e-6, b.dtype)
    texts = {}
    for ch in (True, False):
        texts[ch] = _precond_solve.lower(
            ps.op, ps.pre, x0, b, tol, 2000, False,
            check_halves=ch).as_text()
    assert texts[True] != texts[False]
    assert (texts[False].count("stablehlo.select")
            < texts[True].count("stablehlo.select"))


def test_check_halves_off_distributed(mat900):
    """The flag threads through the shard_map loop (same core, same carry)."""
    from cuda_mat.parallel.mesh import make_mesh
    from cuda_mat.parallel.dist_solver import dist_bicgstab

    b = np.ones(mat900.n)
    cfg = SolverConfig(maxit=2000, tol=1e-8, precond="ilu0_neumann",
                       neumann_terms=3)
    mesh = make_mesh(4)
    r_on = dist_bicgstab(mat900, b, mesh, cfg)
    r_off = dist_bicgstab(mat900, b, mesh, cfg.replace(check_halves=False))
    assert r_on.converged and r_off.converged
    assert 0 <= r_off.iters - r_on.iters <= 1
    np.testing.assert_allclose(r_off.x, r_on.x, rtol=1e-7, atol=1e-9)
