"""Mixed-precision iterative refinement.

The reference computes everything in float64.  The solver loop is
bandwidth-bound, so float32 halves its bytes; the route to reference-grade
accuracy at that speed is classic iterative refinement: solve corrections
in float32 on the device, and
compute the *true residual in float64 on the host* between restarts
(BiCGSTAB is restartable from any iterate, so each outer step is just a
fresh solve of ``A e = r``):

    r_k = b − A x_k          (float64, host)
    e_k ≈ solve(A, r_k)      (float32, device, tol_inner)
    x_{k+1} = x_k + e_k      (float64, host)

Converges to the float64-accurate solution as long as the inner solver
reduces the residual by any fixed factor per restart.

The inner solves run through ONE prepared solver — operator +
preconditioner + compiled loop built once, reused by every restart
(:func:`~cuda_mat.solvers.bicgstab.make_solver` single-chip;
:func:`~cuda_mat.parallel.dist_solver.make_dist_bicgstab` when a
``mesh`` is given) — matching the reference's setup/solve phase split
(pbicgstab.cu:335-363 vs :366): restarts never repeat the setup (the ILU(0)
factorization and the compile).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from cuda_mat.config import SolverConfig, DEFAULT_CONFIG
from cuda_mat.solvers.bicgstab import host_matvec_f64, make_solver
from cuda_mat.solvers.result import SolveResult, SolverStatus


def solve_refined(a, b: np.ndarray, config: SolverConfig = DEFAULT_CONFIG,
                  inner_tol: float = 1e-4, max_restarts: int = 20,
                  x0: Optional[np.ndarray] = None, mesh=None,
                  local_engine: str = "auto", solver=None) -> SolveResult:
    """Solve to ``config.tol`` relative residual in float64 terms, using
    float32 inner solves (``config.dtype`` is forced to float32 on device).

    ``mesh``: run the inner solves through the distributed row-partitioned
    engine over this :class:`jax.sharding.Mesh` (``local_engine`` as in
    :func:`~cuda_mat.parallel.dist_solver.make_dist_bicgstab`) — the
    multi-chip path to the reference convergence contract tol=1e-6
    (example.cpp:179-180).  The outer f64
    residual/correction arithmetic is identical either way.

    ``solver``: a prebuilt :class:`PreparedSolver` /
    :class:`DistBicgstabSolver` for ``a`` to run the inner solves through
    (skips this call's own setup entirely — e.g. the bench shares one
    prepared solver between its plain and refined arms).  Its config should
    solve to ~``inner_tol`` in float32; ``mesh``/``local_engine`` are
    ignored when given.

    The returned ``residual_history`` holds the float64 outer residuals (one
    per restart); ``iters`` is the total inner iteration count.
    """
    t0 = time.perf_counter()
    b64 = np.asarray(b, dtype=np.float64)
    norm_b0: Optional[float] = None
    x = (np.ones(a.n, dtype=np.float64) if x0 is None
         else np.asarray(x0, dtype=np.float64))
    # inner solves skip the per-solve true-residual SpMV: the outer loop
    # already computes the f64 residual each restart
    inner_cfg = config.replace(dtype="float32", tol=inner_tol,
                               true_residual=False)
    if solver is None:
        if mesh is not None:
            from cuda_mat.parallel.dist_solver import make_dist_bicgstab

            solver = make_dist_bicgstab(a, mesh, inner_cfg,
                                        local_engine=local_engine)
        else:
            solver = make_solver(a, inner_cfg)
    zero = np.zeros(a.n)
    total_inner = 0
    outer_hist: List[float] = []
    dt_alg = 0.0
    status = SolverStatus.MAXIT
    rel = np.inf
    prev_nrm = np.inf
    x_prev = x
    for k in range(max_restarts):
        r = b64 - host_matvec_f64(a, x)             # float64 true residual
        nrm = float(np.linalg.norm(r))
        if norm_b0 is None:
            norm_b0 = nrm if nrm > 0 else 1.0       # ||r0|| as in the reference
        outer_hist.append(nrm)
        if nrm > prev_nrm:
            # the last correction made the f64 residual WORSE: the inner f32
            # solve diverged (refinement contracts whenever the inner solver
            # reduces the residual by any factor).  Revert it and stop
            # instead of burning the remaining restarts on garbage
            # corrections — the reverted x and its residual are returned
            # with an honest non-converged status.
            x = x_prev
            rel = prev_nrm / norm_b0
            break
        rel = nrm / norm_b0
        if rel < config.tol:
            status = SolverStatus.CONVERGED
            break
        inner = solver.solve(r, x0=zero)
        dt_alg += inner.dt_alg
        total_inner += inner.iters
        if inner.status == SolverStatus.BREAKDOWN and \
                not np.isfinite(inner.x).all():
            status = SolverStatus.BREAKDOWN
            break
        prev_nrm = nrm
        x_prev = x
        x = x + inner.x.astype(np.float64)
    return SolveResult(
        x=x, status=status, iters=total_inner, residual=float(rel * norm_b0),
        residual0=float(norm_b0), dt_alg=dt_alg,
        dt_setup=time.perf_counter() - t0 - dt_alg,
        residual_history=np.asarray(outer_hist),
        # the outer residual is already the f64 host-computed true residual
        residual_true=float(rel * norm_b0))
