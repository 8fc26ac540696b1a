"""Truncated Neumann-series ILU(0) application (the bandwidth-bound
alternative to triangular sweeps — SURVEY §7 'Jacobi-iteration approximation')."""

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_mat.config import SolverConfig
from cuda_mat.precond.preconditioners import (ILU0Preconditioner,
                                                  NeumannILUPreconditioner)
from cuda_mat.reference.cpu_solvers import (ilu0_factorize,
                                                solve_lower_unit, solve_upper)
from cuda_mat.solvers.bicgstab import solve


def test_series_converges_to_exact_trisolve(mat900, rng):
    """As k grows, the truncated series application approaches the exact
    L/U solves (the factors of the Laplacian are strongly diagonally
    dominant, so rho(N) << 1)."""
    m = ilu0_factorize(mat900)
    f = rng.standard_normal(900)
    exact = solve_upper(mat900, m, solve_lower_unit(mat900, m, f))
    errs = []
    for k in (2, 4, 8, 16):
        pre = NeumannILUPreconditioner.from_csr(mat900, dtype=jnp.float64,
                                                terms=k)
        approx = np.asarray(pre.msolve(jnp.asarray(f)))
        errs.append(np.linalg.norm(approx - exact) / np.linalg.norm(exact))
    assert errs[0] < 0.5
    assert all(b < a for a, b in zip(errs, errs[1:]))  # monotone improvement
    # the factors' iteration matrix has rho ~ 0.6 on this fixture, so 16
    # terms land around 6e-4 — plenty for a preconditioner
    assert errs[-1] < 1e-2


def test_terms_one_is_jacobi_on_the_factor(mat900, rng):
    """k=1 keeps only the j=0 term: msolve(f) = D^-1 f."""
    m = ilu0_factorize(mat900)
    pre = NeumannILUPreconditioner.from_csr(mat900, dtype=jnp.float64, terms=1)
    f = rng.standard_normal(900)
    got = np.asarray(pre.msolve(jnp.asarray(f)))
    np.testing.assert_allclose(got, np.asarray(pre.inv_d) * f, rtol=1e-12)


@pytest.mark.parametrize("terms,max_extra", [(2, 30), (3, 15), (5, 8)])
def test_neumann_solve_converges(mat900, rng, terms, max_extra):
    """The preconditioned solve converges; more terms → closer to the exact
    ILU(0) iteration count."""
    b = rng.uniform(1.0, 5.0, 900)
    exact = solve(mat900, b, SolverConfig(maxit=2000, tol=1e-6,
                                          precond="ilu0", trisolve_block=64))
    res = solve(mat900, b, SolverConfig(maxit=2000, tol=1e-6,
                                        precond="ilu0_neumann",
                                        neumann_terms=terms))
    assert res.converged
    assert res.iters <= exact.iters + max_extra
    rel = np.linalg.norm(b - mat900.matvec(res.x)) / np.linalg.norm(b)
    assert rel < 1e-5


def test_neumann_cli(capsys):
    from cuda_mat.cli import main

    rc = main(["-M", "data/mat900.mtx", "--precond", "ilu0_neumann",
               "--neumann-terms", "4", "--platform", "cpu", "--x64"])
    assert rc == 0
    assert "iterations" in capsys.readouterr().out


def test_neumann_padded_layout_matches_unpadded(rng):
    """pad_like: exact-pattern N_l/N_u restrided into the stencil's strided
    layout produce the same msolve as the plain-operator form (gaps stay
    zero through every term)."""
    from cuda_mat.models.problems import laplacian_2d
    from cuda_mat.ops.stencil import ConstStencilOperator

    a = laplacian_2d(30)                       # the mat900 pattern
    pad_op = ConstStencilOperator.from_dia(a.to_dia(), dtype=jnp.float64,
                                           gap=3)
    pre_pad = NeumannILUPreconditioner.from_csr(a, dtype=jnp.float64,
                                                terms=4, pad_like=pad_op,
                                                const_factors=False)
    pre = NeumannILUPreconditioner.from_csr(a, dtype=jnp.float64, terms=4)
    f = rng.standard_normal(a.n)
    got = np.asarray(pad_op.unpad_vec(pre_pad.msolve(pad_op.pad_vec(f))))
    want = np.asarray(pre.msolve(jnp.asarray(f)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    # gap cells remain exactly zero
    out = np.asarray(pre_pad.msolve(pad_op.pad_vec(f)))
    assert not out.reshape(30, pad_op.stride)[:, 30:].any()


# ---------------------------------------------------------------------------
# Constant-factor + fused-series Neumann on the gap-strided stencil layout
# ---------------------------------------------------------------------------


def _stencil_op(a, dtype=jnp.float64):
    from cuda_mat.solvers.bicgstab import _as_op

    return _as_op(a, dtype, format="stencil")


def test_poly_terms_match_dense_polynomial(rng):
    """neumann_poly_terms(N, k) applied through the gap-strided stencil
    equals the dense polynomial I - N + N^2 (boundary/gap handling
    included)."""
    from cuda_mat.models.problems import grid_laplacian
    from cuda_mat.ops.stencil import neumann_poly_terms, strided_offsets
    from cuda_mat.precond.preconditioners import (_const_factor_operator,
                                                      neumann_factors)
    import dataclasses

    a = grid_laplacian(24, 126)
    op = _stencil_op(a).with_gap(2)
    low, up, diag = neumann_factors(a)
    for f_csr in (low, up):
        n_op = _const_factor_operator(f_csr, op)
        pt = neumann_poly_terms(n_op.terms, 3, n_op.c_grid, n_op.stride)
        p_op = dataclasses.replace(
            n_op, terms=pt,
            strided_terms=strided_offsets(pt, n_op.c_grid, n_op.stride))
        # dense N from the const-factor operator's own terms
        n = a.n
        dense_n = np.zeros((n, n))
        c = n_op.c_grid
        for (off, dc, scal) in n_op.terms:
            for i in range(n):
                j = i + off
                if 0 <= j < n and 0 <= (i % c) + dc < c:
                    dense_n[i, j] = scal
        dense_p = np.eye(n) - dense_n + dense_n @ dense_n
        x = rng.standard_normal(n)
        y_kernel = np.asarray(p_op.unpad_vec(p_op.matvec(p_op.pad_vec(x))))
        np.testing.assert_allclose(y_kernel, dense_p @ x, rtol=1e-12,
                                   atol=1e-12)


def test_fused_msolve_matches_sequential_const(rng):
    """Per-triangle fused series ("series" level) == sequential const series
    (same polynomial, expanded)."""
    from cuda_mat.models.problems import grid_laplacian
    from cuda_mat.precond.preconditioners import (
        _const_factor_operator, _fused_series_operator, neumann_factors)

    a = grid_laplacian(24, 126)
    op = _stencil_op(a).with_gap(2)
    low, up, diag = neumann_factors(a)
    nl = _const_factor_operator(low, op)
    nu = _const_factor_operator(up, op)
    pre_f = NeumannILUPreconditioner(_fused_series_operator(nl, 3),
                                     _fused_series_operator(nu, 3),
                                     op.pad_vec(1.0 / diag), 3,
                                     fused=True)
    pre_s = NeumannILUPreconditioner(nl, nu, op.pad_vec(1.0 / diag), 3)
    f = op.pad_vec(rng.standard_normal(a.n))
    np.testing.assert_allclose(np.asarray(pre_f.msolve(f)),
                               np.asarray(pre_s.msolve(f)),
                               rtol=1e-13, atol=1e-13)


def test_kernel_msolve_engages_through_solve(rng):
    """solve() on the stencil path widens the layout's gap for the series
    and from_csr selects the fused whole-series msolve (the production
    single-chip msolve)."""
    from unittest import mock

    from cuda_mat.models.problems import grid_laplacian
    from cuda_mat.precond.preconditioners import NeumannILUPreconditioner

    a = grid_laplacian(40, 126)
    b = a.matvec(rng.standard_normal(a.n))
    cfg = SolverConfig(maxit=2000, tol=1e-4, dtype="float64",
                       precond="ilu0_neumann", neumann_terms=3)
    made = []
    orig = NeumannILUPreconditioner.from_csr.__func__

    def spy(cls, *args, **kw):
        pre = orig(cls, *args, **kw)
        made.append(pre.fused)
        return pre

    with mock.patch.object(NeumannILUPreconditioner, "from_csr",
                           classmethod(spy)):
        r = solve(a, b, cfg, format="stencil")
    assert r.converged
    assert made == [True]


def test_const_factor_solve_converges_like_exact_pattern(rng):
    """Const-factor (boundary-layer-perturbed) Neumann costs ~zero extra
    iterations at the production tolerance."""
    from cuda_mat.models.problems import grid_laplacian

    a = grid_laplacian(40, 126)
    b = a.matvec(rng.standard_normal(a.n))
    cfg = SolverConfig(maxit=2000, tol=1e-4, dtype="float64",
                       precond="ilu0_neumann", neumann_terms=3)
    r_c = solve(a, b, cfg.replace(neumann_const_factors=True),
                format="stencil")
    r_e = solve(a, b, cfg.replace(neumann_const_factors=False),
                format="stencil")
    assert r_c.converged and r_e.converged
    assert abs(r_c.iters - r_e.iters) <= max(2, 0.15 * r_e.iters)


def test_min_sub_rebuild_for_wide_grids(rng):
    """When the fused series' within-row reach exceeds the operator's
    default gap, make_solver rebuilds the layout with a wider gap so the
    fused path still engages (also on a wide grid)."""
    from cuda_mat.models.problems import grid_laplacian
    from cuda_mat.solvers.bicgstab import make_solver

    a = grid_laplacian(8, 1000)
    b = a.matvec(rng.standard_normal(a.n))
    cfg = SolverConfig(maxit=2000, tol=1e-6, dtype="float64",
                       precond="ilu0_neumann", neumann_terms=4)
    assert _stencil_op(a).stride == 1001
    ps = make_solver(a, cfg, format="stencil")
    assert ps.op.stride == 1003 and ps.pre.fused
    r = ps.solve(b)
    assert r.converged


def test_gap_overflow_falls_back_to_sequential(rng):
    """k large enough that series |dc| exceeds the gap width: from_csr falls
    back to the sequential const-factor series instead of mis-masking."""
    from cuda_mat.models.problems import grid_laplacian

    a = grid_laplacian(24, 126)
    op = _stencil_op(a).with_gap(2)
    pre = NeumannILUPreconditioner.from_csr(a, dtype=jnp.float64, terms=4,
                                            pad_like=op, const_factors=True)
    assert not pre.fused            # |dc| = 3 > gap 2
    # and it still applies correctly (sequential const series)
    f = op.pad_vec(rng.standard_normal(a.n))
    y = np.asarray(pre.msolve(f))
    assert np.isfinite(y).all()


def test_milu_factor_row_sums_and_native_parity(mat900):
    """omega=1 MILU preserves A's row sums through L.U; the native cmt_milu0
    and the numpy fallback agree to accumulation-order ulps (the dropped-fill
    sum is a reduction, so bit-identity is not guaranteed as it is for plain
    ILU(0)); omega=0 degenerates to ILU(0) exactly."""
    from cuda_mat.precond.preconditioners import milu0_factorize

    m = milu0_factorize(mat900, 1.0)
    n = mat900.n
    rows = np.repeat(np.arange(n), np.diff(mat900.indptr))
    cols = mat900.indices
    L = np.eye(n)
    U = np.zeros((n, n))
    L[rows[cols < rows], cols[cols < rows]] = m[cols < rows]
    U[rows[cols >= rows], cols[cols >= rows]] = m[cols >= rows]
    ones = np.ones(n)
    np.testing.assert_allclose(L @ (U @ ones), mat900.matvec(ones),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(milu0_factorize(mat900, 0.0),
                                  ilu0_factorize(mat900))
    try:
        from cuda_mat.native import loader
        native_ok = loader.available()
    except ImportError:
        native_ok = False
    if native_ok:
        for omega in (0.5, 0.97, 1.0):
            np.testing.assert_allclose(
                loader.milu0_factorize(mat900, omega),
                milu0_factorize(mat900, omega), rtol=1e-12, atol=1e-13)


def test_milu_omega_cuts_iterations(rng):
    """Relaxed MILU (omega=0.97) conditions the Laplacian far better than
    plain ILU(0): solve-level iteration count drops by a wide margin at
    40k rows with the k=4 Neumann series, on both the generic and stencil
    paths."""
    from cuda_mat.models.problems import grid_laplacian

    a = grid_laplacian(400, 100)
    b = np.ones(a.n)
    cfg = SolverConfig(maxit=2000, tol=1e-6, dtype="float64",
                       precond="ilu0_neumann", neumann_terms=4)
    r0 = solve(a, b, cfg, format="dia")
    r1 = solve(a, b, cfg.replace(milu_omega=0.97), format="dia")
    assert r0.converged and r1.converged
    assert r1.iters <= r0.iters - 15, (r0.iters, r1.iters)
    rel = np.linalg.norm(b - a.matvec(r1.x)) / np.linalg.norm(b)
    assert rel < 1e-5
    # stencil path: the interior-constant factor machinery must handle the
    # MILU factor (its diagonals converge to different fixed points)
    r2 = solve(a, b, cfg.replace(milu_omega=0.97), format="stencil")
    assert r2.converged
    assert r2.iters <= r0.iters - 15, (r0.iters, r2.iters)


def test_milu_omega_exact_ilu_path(rng):
    """milu_omega also flows through the exact-trisolve ilu0 path (the
    modified factor feeds the same blocked triangular solves)."""
    from cuda_mat.models.problems import grid_laplacian

    a = grid_laplacian(100, 100)
    b = np.ones(a.n)
    cfg = SolverConfig(maxit=2000, tol=1e-6, dtype="float64",
                       precond="ilu0", trisolve_block=128)
    r0 = solve(a, b, cfg)
    r1 = solve(a, b, cfg.replace(milu_omega=0.97))
    assert r0.converged and r1.converged
    # numpy sweep at this size: exact ILU 45 vs exact MILU(0.97) 20
    assert r1.iters < r0.iters, (r0.iters, r1.iters)
    rel = np.linalg.norm(b - a.matvec(r1.x)) / np.linalg.norm(b)
    assert rel < 1e-5
