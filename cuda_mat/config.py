"""Solver configuration and numerics toggles.

The reference hardcodes its solve parameters in the CLI (maxit=2000, tol=1e-6,
reference example.cpp:179-180) and threads them positionally through the C API
(reference pbicgstab.h:96-110).  Here they live in one dataclass that every
entry point accepts.
"""

from __future__ import annotations

import dataclasses


def use_x64(enable: bool = True) -> None:
    """Enable float64 in JAX (needed to reproduce the reference's double-precision
    convergence trajectories; reference computes everything in ``double``)."""
    import jax

    jax.config.update("jax_enable_x64", enable)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Parameters of a BiCGSTAB/BiCG solve.

    Defaults follow the reference CLI: maxit=2000, tol=1e-6
    (reference example.cpp:179-180).  ``breakdown_tol`` is the |omega| guard of
    the unpreconditioned reference paths (reference pbicgstab.cu:559).
    """

    maxit: int = 2000
    tol: float = 1e-6
    breakdown_tol: float = 1e-5
    debug: bool = False
    # dtype for device computation; float64 requires use_x64() (the
    # reference's precision); float32 halves the bytes of the bandwidth-bound
    # loop for large runs (solve_refined restores f64-grade accuracy)
    dtype: str = "float64"
    # preconditioner: "none" | "jacobi" | "ilu0" | "ilu0_neumann" |
    # "bjacobi_ilu0" (distributed only)
    precond: str = "none"
    # block size for the blocked triangular solve (ILU(0) path)
    trisolve_block: int = 128
    # bandwidth-reducing reordering applied before the solve:
    # "none" (default — preserves the reference trajectory exactly) | "rcm"
    # (reverse Cuthill–McKee; makes badly-ordered banded-able matrices
    # eligible for the no-gather DIA SpMV path).  The solution is
    # scattered back to the original ordering, so x is exact either way.
    reorder: str = "none"
    # terms k of the truncated Neumann series for precond="ilu0_neumann"
    # (2(k-1) banded SpMVs per application; see precond.NeumannILUPreconditioner)
    neumann_terms: int = 3
    # on the gap-strided stencil path, approximate the Neumann factors by
    # their deep-interior fixed-point constants and run them matrix-free
    # (kills the restrided factor value streams — the dominant msolve
    # traffic; perturbs the preconditioner only in a boundary layer).
    # False = exact-pattern factors restrided into the stencil layout.
    neumann_const_factors: bool = True
    # relaxed modified-ILU(0) factor values for the ilu0 / ilu0_neumann /
    # bjacobi_ilu0 preconditioners: omega times each row's dropped fill is
    # subtracted from its diagonal (omega=1 preserves A's row sums —
    # classic MILU).  0 (default) = reference-parity ILU(0).
    # On the Laplacian family omega~0.96-0.97 cuts BiCGSTAB iterations
    # ~30% (O(h^-1) vs O(h^-2) conditioning); the truncated Neumann series
    # needs omega < 1 to keep the factor diagonally dominant.
    # Beyond-reference option.
    milu_omega: float = 0.0
    # recompute ||b - A x|| in float64 on the host after the solve (one host
    # SpMV, outside dtAlg) and report it as SolveResult.residual_true; the
    # in-loop recursive residual drifts from the true residual in f32
    true_residual: bool = True
    # Reference parity: convergence is tested after EACH half-iteration of
    # the preconditioned loop (reference pbicgstab.cu:116,147).  False =
    # test only after full iterations: the first-half dot + sqrt + compare
    # and the ~4 selects guarding the dead half-iteration drop out of the
    # loop body.
    # Trajectory-identical except at the exit (a first-half exit becomes a
    # completed iteration; the residual only gets smaller).  Keep True for
    # exact reference trajectory/iteration-count parity.
    check_halves: bool = True

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SolverConfig()
