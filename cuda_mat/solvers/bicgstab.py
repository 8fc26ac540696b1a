"""BiCGSTAB solver family as single ``lax.while_loop``s under ``jit``.

The central design departure from the reference: its GPU loops sync ~6 scalar
dot/norm results to the host *per iteration* to compute alpha/beta/omega and
decide the convergence branch (reference pbicgstab.cu:81,106,111,135-136,142
and the host-side branches at :116,:147).  Here the entire iteration —
SpMV, preconditioner solves, all BLAS1 ops, scalar recurrences, and the
convergence/breakdown decisions — is one jitted ``lax.while_loop``; XLA fuses
every vector op between SpMV calls and nothing touches the host until the
solve finishes.

Three public entry points mirror reference pbicgstab.h:113-120:

- :func:`bicgstab`            — plain CSR, h-form loop (pbicgstab.cu:425-578,
  with the intended residual init; see cpu_solvers docstring)
- :func:`bicgstab_split`      — ``A = A0 + diag(d)`` (pbicgstab.cu:581-754)
- :func:`bicgstab_lu_precond` — ILU(0) preconditioned (pbicgstab.cu:45-154)

plus a generic :func:`solve` that picks the preconditioner from
``SolverConfig``.
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cuda_mat.config import SolverConfig, DEFAULT_CONFIG
from cuda_mat.formats.csr import CSRMatrix
from cuda_mat.ops.operators import make_operator, SplitOperator
from cuda_mat.ops.selection import check_platform, select_format
from cuda_mat.ops.stencil import ConstStencilOperator, series_gap
from cuda_mat.precond.preconditioners import (
    IdentityPreconditioner,
    make_preconditioner,
)
from cuda_mat.solvers.result import SolveResult, SolverStatus

_RUNNING = 0
_CONVERGED = 1
_BREAKDOWN = 2


def dot(u: jax.Array, v: jax.Array) -> jax.Array:
    """Solver inner product at full precision: a float32 product may
    otherwise run at reduced (TF32) precision on the GPU, which the residual
    recurrences do not tolerate."""
    return jnp.dot(u, v, precision=jax.lax.Precision.HIGHEST)


class _HState(NamedTuple):
    i: jax.Array
    status: jax.Array
    x: jax.Array
    x0: jax.Array
    r: jax.Array
    p: jax.Array
    v: jax.Array
    rho: jax.Array
    alpha: jax.Array
    omega: jax.Array
    norm: jax.Array
    hist: jax.Array


def hform_core(matvec, dot, x0, b, tol, btol, maxit, debug=False):
    """h-form BiCGSTAB loop (reference gpu_pbicgstab2, pbicgstab.cu:488-573):
    scalar recurrences rho/alpha/omega, explicit intermediate h = x0 + αp̂,
    convergence check then |omega| breakdown guard, state ping-pong at the
    end of each iteration (here: just the new carry).

    Generic over ``matvec`` and ``dot`` so the same algorithm runs single-chip
    (``dot`` = :func:`dot`) and inside ``shard_map`` (``dot`` = local partial +
    ``psum``, ``matvec`` = halo-exchange SpMV) — the distributed path shares
    this exact code (SURVEY §2 distributed component 3)."""
    dt = b.dtype
    one = jnp.asarray(1.0, dt)
    r = b - matvec(x0)
    r0 = r
    norm0 = jnp.sqrt(dot(r, r))
    if debug:
        jax.debug.print("initial norm = {}", norm0)

    def cond(st: _HState):
        return (st.i < maxit) & (st.status == _RUNNING)

    def body(st: _HState) -> _HState:
        rho_ = dot(r0, st.r)
        beta = (rho_ / st.rho) * (st.alpha / st.omega)
        p_ = st.r + beta * (st.p - st.omega * st.v)
        v_ = matvec(p_)
        alpha = rho_ / dot(r0, v_)
        h = st.x0 + alpha * p_
        s = st.r - alpha * v_
        t = matvec(s)
        omega = dot(t, s) / dot(t, t)
        x = h + omega * s
        r_ = s - omega * t
        norm = jnp.sqrt(dot(r_, r_))
        if debug:
            jax.debug.print("k = {}, norm = {}", st.i, norm)
        conv = norm < tol * norm0
        broke = (~conv) & ((jnp.abs(omega) < btol) | jnp.isnan(omega))
        status = jnp.where(conv, _CONVERGED,
                           jnp.where(broke, _BREAKDOWN, _RUNNING)
                           ).astype(jnp.int32)
        hist = st.hist.at[st.i].set(norm)
        return _HState(st.i + 1, status, x, x, r_, p_, v_, rho_, alpha, omega,
                       norm, hist)

    z = jnp.zeros_like(b)
    init = _HState(jnp.int32(0), jnp.int32(_RUNNING), z, x0, r, z, z,
                   one, one, one, norm0, jnp.full((maxit,), -1.0, dt))
    st = jax.lax.while_loop(cond, body, init)
    return st.x, st.status, st.i, st.norm, norm0, st.hist


@partial(jax.jit, static_argnames=("maxit", "debug"))
def _hform_solve(op, x0, b, tol, btol, maxit, debug=False):
    return hform_core(op.matvec, dot, x0, b, tol, btol, maxit, debug)


class _PState(NamedTuple):
    i: jax.Array
    status: jax.Array
    x: jax.Array
    r: jax.Array
    p: jax.Array
    v: jax.Array
    rho: jax.Array
    alpha: jax.Array
    omega: jax.Array
    nrmr: jax.Array
    hist: jax.Array


def precond_core(matvec, msolve, dot, x0, b, tol, maxit, debug=False,
                 check_halves=True):
    """Preconditioned BiCGSTAB loop (reference gpu_pbicgstab,
    pbicgstab.cu:45-154): two M-solve + SpMV half-steps per iteration with a
    convergence check after each; the first check exits *without* bumping the
    iteration counter (reference :116), the second bumps it (:147-150).

    Generic over ``matvec``/``msolve``/``dot`` (see :func:`hform_core`).

    ``check_halves=False`` elides the reference's *first-half* convergence
    check (reference pbicgstab.cu:116) — the dot + sqrt + compare + the four
    selects that guard the dead half-iteration disappear from the loop body
    and convergence is only tested after full iterations (:147).  The
    trajectory is unchanged except at the exit: a solve that would have
    exited on a first half-step runs its second half too (one extra msolve +
    SpMV once per solve, and the residual only gets smaller).  On by default
    for reference trajectory parity."""
    dt = b.dtype
    one = jnp.asarray(1.0, dt)
    r = b - matvec(x0)
    rw = r
    nrmr0 = jnp.sqrt(dot(r, r))
    if debug:
        jax.debug.print("gpu, init residual:norm {}", nrmr0)

    def cond(st: _PState):
        return (st.i < maxit) & (st.status == _RUNNING)

    def body(st: _PState) -> _PState:
        # "Flat" (branch-free) body: no lax.cond — the two data-dependent
        # branches of the reference loop (the i==0 p-init and the first-half
        # convergence exit, pbicgstab.cu:83-89,:116) become selects around
        # unconditionally-executed compute, so the body is one straight-line
        # graph (the selected values, status, counter, and history are those
        # of the branching form; the only addition is one discarded
        # half-iteration at the exit).  Divisors are select-guarded so the dead half-iteration can never
        # manufacture NaN/Inf (keeps --debug-nans usable and breakdown
        # detection exact).
        rhop = st.rho
        rho = dot(rw, st.r)
        first = st.i == 0
        beta = jnp.where(first, jnp.asarray(0.0, dt),
                         (rho / jnp.where(first, one, rhop))
                         * (st.alpha / st.omega))
        p = st.r + beta * (st.p - st.omega * st.v)
        pw = msolve(p)
        v = matvec(pw)
        alpha = rho / dot(rw, v)
        r1 = st.r - alpha * v
        x1 = st.x + alpha * pw
        if check_halves:
            nrmr1 = jnp.sqrt(dot(r1, r1))
            if debug:
                jax.debug.print("i = {}, residual norm (before precond) = {}",
                                st.i, nrmr1)
            conv1 = nrmr1 < tol * nrmr0
        s = msolve(r1)
        t = matvec(s)
        num_o = dot(t, r1)
        den_o = dot(t, t)
        if check_halves:
            omega_c = (jnp.where(conv1, one, num_o)
                       / jnp.where(conv1, one, den_o))
            omega = jnp.where(conv1, st.omega, omega_c)
            x2 = jnp.where(conv1, x1, x1 + omega_c * s)
            r2 = jnp.where(conv1, r1, r1 - omega_c * t)
            nrmr2 = jnp.where(conv1, nrmr1, jnp.sqrt(dot(r2, r2)))
        else:
            # full-iteration checks only: the first-half dot/sqrt/compare and
            # the selects guarding the dead half-iteration are gone entirely
            conv1 = jnp.asarray(False)
            omega = num_o / den_o
            x2 = x1 + omega * s
            r2 = r1 - omega * t
            nrmr2 = jnp.sqrt(dot(r2, r2))
        if debug:
            jax.debug.print("i = {}, residual norm = {}", st.i, nrmr2)
        conv2 = (~conv1) & (nrmr2 < tol * nrmr0)
        # the reference's preconditioned loop has no NaN guard and would spin
        # to maxit on a float breakdown (its *unpreconditioned* loops do guard,
        # pbicgstab.cu:559) — we surface BREAKDOWN instead of burning maxit
        broke = (~conv1) & (~conv2) & (jnp.isnan(nrmr2) | jnp.isnan(alpha))
        status = jnp.where(conv1 | conv2, _CONVERGED,
                           jnp.where(broke, _BREAKDOWN, _RUNNING)
                           ).astype(jnp.int32)
        if check_halves:
            i_next = jnp.where(conv1, st.i, st.i + 1).astype(jnp.int32)
            pair = jnp.stack([nrmr1, jnp.where(conv1, -one, nrmr2)])
        else:
            i_next = (st.i + 1).astype(jnp.int32)
            pair = jnp.stack([-one, nrmr2])   # first-half slots stay unused
        hist = jax.lax.dynamic_update_slice(st.hist, pair, (2 * st.i,))
        return _PState(i_next, status, x2, r2, p, v, rho, alpha, omega,
                       nrmr2, hist)

    init = _PState(jnp.int32(0), jnp.int32(_RUNNING), x0, r, r,
                   jnp.zeros_like(b), jnp.asarray(0.0, dt), one, one, nrmr0,
                   jnp.full((2 * maxit,), -1.0, dt))
    st = jax.lax.while_loop(cond, body, init)
    return st.x, st.status, st.i, st.nrmr, nrmr0, st.hist


@partial(jax.jit, static_argnames=("maxit", "debug", "check_halves"))
def _precond_solve(op, pre, x0, b, tol, maxit, debug=False,
                   check_halves=True):
    return precond_core(op.matvec, pre.msolve, dot, x0, b, tol, maxit,
                        debug, check_halves=check_halves)


# ---------------------------------------------------------------------------
# Host-facing wrappers
# ---------------------------------------------------------------------------

def _as_op(a, dtype, format=None):
    """The device operator for ``a`` (a host CSR matrix, or an operator
    passed through): the matrix-free stencil operator when
    :func:`~cuda_mat.ops.selection.select_format` proves a constant grid
    stencil, else a plain-vector operator."""
    check_platform()
    if isinstance(a, CSRMatrix):
        if a.n != a.m:
            raise ValueError(
                f"square matrix is expected, got {a.n}x{a.m}")  # cf. example.cpp:257-260
        fmt, dia = select_format(a, format)
        if fmt == "stencil":
            return ConstStencilOperator.from_dia(dia, dtype=dtype)
        return make_operator(a, dtype=dtype, format=fmt)
    return a  # already a device operator


def _is_padded(op) -> bool:
    return hasattr(op, "pad_vec")


def host_matvec_f64(a, x) -> np.ndarray:
    """``A x`` in float64 on the host.  For CSR this uses bincount instead of
    CSRMatrix.matvec's np.add.at — same sum, ~20x faster at bench scale
    (50M nnz); used by the true-residual report and iterative refinement."""
    x64 = np.asarray(x, np.float64)
    if isinstance(a, CSRMatrix):
        rows = np.repeat(np.arange(a.n), a.row_lengths)
        return np.bincount(rows, weights=np.asarray(a.data, np.float64)
                           * x64[a.indices], minlength=a.n)
    return np.asarray(a.matvec(x64), np.float64)


def _host_residual_norm(a, x, b) -> float:
    """``||b - A x||_2`` recomputed in float64 on the host — the honest
    convergence number next to the iteration's recursive residual (reference
    convergence contract pbicgstab.cu:116,147; one SpMV, outside dtAlg)."""
    return float(np.linalg.norm(np.asarray(b, np.float64)
                                - host_matvec_f64(a, x)))


def _attach_true_residual(res: SolveResult, a, b, config: SolverConfig,
                          d=None) -> SolveResult:
    from cuda_mat.formats.dia import DIAMatrix

    if config.true_residual and isinstance(a, (CSRMatrix, DIAMatrix)):
        bb = np.asarray(b, np.float64)
        if d is not None:                     # split form A = A0 + diag(d)
            bb = bb - np.asarray(d, np.float64) * np.asarray(res.x, np.float64)
        res.residual_true = _host_residual_norm(a, res.x, bb)
    return res


def _check_shapes(op, b):
    b = np.asarray(b)
    if b.ndim != 1 or b.shape[0] != op.n:
        raise ValueError(
            f"b must be a vector of length n={op.n}, got shape {b.shape}"
        )  # cf. example.cpp:320-328


def _finish(x, status, iters, nrmr, nrmr0, hist, t_alg, t_setup, maxit
            ) -> SolveResult:
    status = int(status)
    if status == _RUNNING:
        status = SolverStatus.MAXIT
    return SolveResult(
        x=np.asarray(x), status=SolverStatus(status), iters=int(iters),
        residual=float(nrmr), residual0=float(nrmr0), dt_alg=t_alg,
        dt_setup=t_setup, residual_history=np.asarray(hist))


def bicgstab(a, b, config: SolverConfig = DEFAULT_CONFIG,
             x0: Optional[np.ndarray] = None, format: Optional[str] = None
             ) -> SolveResult:
    """Plain BiCGSTAB on CSR, x0 = all-ones by default (reference wrapper
    pbicgstab.cu:756-922, x0 init at :827-832)."""
    cfg = config if config.precond in (None, "none", "identity") \
        else config.replace(precond="none")
    return make_solver(a, cfg, format=format).solve(b, x0=x0)


def bicgstab_split(a0, d, x0, b, config: SolverConfig = DEFAULT_CONFIG,
                   format: Optional[str] = None) -> SolveResult:
    """BiCGSTAB on the split form ``(A0 + diag(d)) x = b`` with caller-supplied
    x0 (reference pbicgstab.cu:926-1088; SpMV is the fused d∘x + A0·x)."""
    dt = jnp.dtype(config.dtype)
    t0 = time.perf_counter()
    base = _as_op(a0, dt, format)
    padded = _is_padded(base)
    if padded:
        # pad d alongside the vectors: the pad region of d is zero, padded x
        # stays zero, so d∘x keeps the padding a fixed point of the iteration
        op = SplitOperator(base, base.pad_vec(np.asarray(d)))
        _check_shapes(op, b)
        bd = base.pad_vec(np.asarray(b))
        x0d = base.pad_vec(np.asarray(x0))
    else:
        op = SplitOperator(base, jnp.asarray(d, dt))
        _check_shapes(op, b)
        bd = jnp.asarray(b, dt)
        x0d = jnp.asarray(x0, dt)
    jax.block_until_ready((op, bd, x0d))
    t1 = time.perf_counter()
    out = _hform_solve(op, x0d, bd, jnp.asarray(config.tol, dt),
                       jnp.asarray(config.breakdown_tol, dt), config.maxit,
                       config.debug)
    out = jax.block_until_ready(out)
    t2 = time.perf_counter()
    out = (base.unpad_vec(out[0]),) + out[1:] if padded else out
    return _attach_true_residual(
        _finish(*out, t2 - t1, t1 - t0, config.maxit), a0, b, config, d=d)


def bicgstab_lu_precond(a, b, config: SolverConfig = DEFAULT_CONFIG,
                        format: Optional[str] = None) -> SolveResult:
    """ILU(0)-preconditioned BiCGSTAB, x0 = all-ones (reference
    bicgstab_lu_precond, pbicgstab.cu:157-409; x0 at :306-308).  Unlike the
    reference — which always returns true (:408) — the result carries real
    convergence status."""
    cfg = config.replace(precond="ilu0")
    return solve(a, b, cfg, format=format)


def solve(a, b, config: SolverConfig = DEFAULT_CONFIG,
          x0: Optional[np.ndarray] = None, format: Optional[str] = None
          ) -> SolveResult:
    """Generic preconditioned solve; ``config.precond`` selects
    none/jacobi/ilu0.  One-shot convenience over :func:`make_solver` —
    repeated solves of the same matrix should build a
    :class:`PreparedSolver` once instead (the operator/preconditioner setup
    re-runs here on every call; reference setup/solve phase split
    pbicgstab.cu:335-363 vs :366)."""
    return make_solver(a, config, format=format).solve(b, x0=x0)


def _build_setup(a, op, padded, dt, config: SolverConfig):
    """Preconditioner construction for ``op``/``a`` (the reference's setup
    phase: analysis + ILU(0) factorization, pbicgstab.cu:335-363).  May
    *replace* ``op`` (a wider stencil gap for the fused Neumann series, or
    the non-padded fallback when the factors cannot restride) — returns
    ``(op, pre, padded)``."""
    if config.precond in (None, "none", "identity"):
        return op, None, padded
    if isinstance(a, CSRMatrix):
        if padded and config.precond == "ilu0":
            # exact ILU(0): keep the stencil SpMV — the triangular solvers
            # work on true-n vectors, so adapt them at the msolve boundary
            from cuda_mat.precond.preconditioners import (
                PaddedPreconditioner)

            pre = PaddedPreconditioner(
                make_preconditioner("ilu0", a, block=config.trisolve_block,
                                    dtype=dt,
                                    milu_omega=config.milu_omega), op)
        elif padded and config.precond == "jacobi":
            from cuda_mat.precond.preconditioners import JacobiPreconditioner

            diag = a.diagonal()
            if np.any(diag == 0):
                raise ValueError(
                    "Jacobi preconditioner requires a nonzero diagonal")
            pre = JacobiPreconditioner(op.pad_vec(1.0 / diag))
        elif padded and config.precond == "ilu0_neumann":
            # build N_l/N_u in the operator's strided layout: the whole
            # preconditioned iteration then runs on strided vectors
            from cuda_mat.precond.preconditioners import (
                NeumannILUPreconditioner)

            if config.neumann_const_factors:
                # widen the gap so each triangle's whole series is one exact
                # stencil (costs A's matvec only the extra gap cells)
                gap = series_gap(op.terms, config.neumann_terms)
                if gap > op.stride - op.c_grid:
                    op = op.with_gap(gap)
            try:
                pre = NeumannILUPreconditioner.from_csr(
                    a, dtype=dt, terms=config.neumann_terms, pad_like=op,
                    const_factors=config.neumann_const_factors,
                    milu_omega=config.milu_omega)
            except ValueError:
                op = make_operator(a, dtype=dt, format=None)
                padded = False
                pre = make_preconditioner(config.precond, a,
                                          block=config.trisolve_block,
                                          dtype=dt,
                                          terms=config.neumann_terms,
                                          milu_omega=config.milu_omega)
        else:
            pre = make_preconditioner(config.precond, a,
                                      block=config.trisolve_block, dtype=dt,
                                      terms=config.neumann_terms,
                                      milu_omega=config.milu_omega)
    else:
        pre = IdentityPreconditioner()
    return op, pre, padded


class PreparedSolver:
    """A prepared (operator + preconditioner + jitted loop) single-chip
    solver — the twin of
    :class:`~cuda_mat.parallel.dist_solver.DistBicgstabSolver`.

    Built once by :func:`make_solver`; :meth:`solve` may then be called for
    any number of right-hand sides without re-running ``_as_op`` (DIA
    conversion + stencil detection) or re-factorizing the
    ILU(0) preconditioner.  Mirrors the reference's setup/solve phase split
    (analysis + csrilu0 once, pbicgstab.cu:335-363; ``gpu_pbicgstab`` per
    call, :366).  The jitted loops (:func:`_hform_solve` /
    :func:`_precond_solve`) are module-level jit caches keyed on the
    op/pre pytree *structure*, so two PreparedSolvers of the same
    configuration also share one compiled graph."""

    def __init__(self, a, op, pre, padded, dt, config: SolverConfig,
                 dt_setup: float, perm=None):
        self.a = a
        self.op = op
        self.pre = pre
        self._padded = padded
        self._dt = dt
        self._config = config
        self.dt_setup = dt_setup
        self._perm = perm          # RCM permutation (input ordering -> op's)

    @property
    def n(self) -> int:
        return self.op.n

    def _prep_vec(self, v) -> jax.Array:
        v = np.asarray(v)
        if self._perm is not None:
            from cuda_mat.formats.reorder import permute_vector

            v = permute_vector(v, self._perm)
        if self._padded:
            return self.op.pad_vec(v)
        return jnp.asarray(v, self._dt)

    def solve(self, b, x0: Optional[np.ndarray] = None) -> SolveResult:
        """Solve ``A x = b``; ``x0`` defaults to all-ones (reference
        pbicgstab.cu:306-308, :827-832)."""
        cfg = self._config
        _check_shapes(self.op, b)
        bd = self._prep_vec(b)
        x0d = self._prep_vec(np.ones(self.op.n) if x0 is None else x0)
        # dtAlg excludes H2D transfers (reference pbicgstab.h:108-109):
        # force the uploads to finish before starting the solve timer
        jax.block_until_ready((bd, x0d))
        t1 = time.perf_counter()
        if self.pre is None:
            out = _hform_solve(self.op, x0d, bd,
                               jnp.asarray(cfg.tol, self._dt),
                               jnp.asarray(cfg.breakdown_tol, self._dt),
                               cfg.maxit, cfg.debug)
        else:
            out = _precond_solve(
                self.op, self.pre, x0d, bd, jnp.asarray(cfg.tol, self._dt),
                cfg.maxit, cfg.debug, check_halves=cfg.check_halves)
        out = jax.block_until_ready(out)
        t2 = time.perf_counter()
        out = (self.op.unpad_vec(out[0]),) + out[1:] if self._padded else out
        if self._perm is not None:
            from cuda_mat.formats.reorder import unpermute_vector

            out = (unpermute_vector(out[0], self._perm),) + out[1:]
        return _attach_true_residual(
            _finish(*out, t2 - t1, self.dt_setup, cfg.maxit), self.a, b, cfg)


def make_solver(a, config: SolverConfig = DEFAULT_CONFIG,
                format: Optional[str] = None) -> PreparedSolver:
    """Build the operator + preconditioner + jitted loop once; the returned
    :class:`PreparedSolver` solves any number of right-hand sides.  This is
    the single-chip twin of
    :func:`~cuda_mat.parallel.dist_solver.make_dist_bicgstab`
    (reference setup/solve split pbicgstab.cu:335-374)."""
    t0 = time.perf_counter()
    perm = None
    a_in = a
    cfg = config
    if cfg.reorder not in (None, "none") and isinstance(a, CSRMatrix):
        if cfg.reorder != "rcm":
            raise ValueError(f"unknown reorder {cfg.reorder!r}")
        from cuda_mat.formats.reorder import permute_csr, rcm_permutation

        perm = rcm_permutation(a)
        a_in = permute_csr(a, perm)
        cfg = cfg.replace(reorder="none")
    dt = jnp.dtype(cfg.dtype)
    op = _as_op(a_in, dt, format)
    op, pre, padded = _build_setup(a_in, op, _is_padded(op), dt, cfg)
    jax.block_until_ready((op, pre))
    # keep the ORIGINAL a for the true-residual check: x is unpermuted back
    # to the input ordering before _attach_true_residual runs
    return PreparedSolver(a, op, pre, padded, dt, cfg,
                          time.perf_counter() - t0, perm=perm)
