"""Plain BiCG as a jitted ``lax.while_loop`` — the device twin of the
reference's CPU OpenMP comparison solver.

Matches the update order of reference bicstab_omp/bicstab.cpp:93-196,
including its two quirks: the convergence check uses the *entering* residual
``sqrt(<R,R>)/||b||`` (reference :164), and on the converged pass the final
``x += alfa*P`` update is skipped (the check at :164-165 breaks before the
update at :167-168).  BiCG needs Aᵀ; the transpose operator is built at load
time (the numpy CSR transpose replaces reference ``Transpose2``,
bicstab.cpp:35-66, whose int-truncation value bug we do not reproduce).
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
from cuda_mat.ops.operators import make_operator
from cuda_mat.solvers.bicgstab import dot
from cuda_mat.solvers.result import SolveResult, SolverStatus


class _BState(NamedTuple):
    i: jax.Array
    status: jax.Array
    x: jax.Array
    r: jax.Array
    bir: jax.Array
    p: jax.Array
    bip: jax.Array
    check: jax.Array
    hist: jax.Array


@partial(jax.jit, static_argnames=("maxit", "debug"))
def _bicg_solve(op, op_t, b, eps, maxit, debug=False):
    dt = b.dtype
    norm = jnp.sqrt(dot(b, b))
    x = jnp.ones_like(b)
    r = b - op.matvec(x)

    def cond(st: _BState):
        return (st.i < maxit) & (st.status == 0)

    def body(st: _BState) -> _BState:
        ap = op.matvec(st.p)
        atbip = op_t.matvec(st.bip)
        numerator = dot(st.bir, st.r)
        alfa = numerator / dot(st.bip, ap)
        nr = st.r - alfa * ap
        nbir = st.bir - alfa * atbip
        beta = dot(nbir, nr) / numerator
        np_ = nr + beta * st.p
        nbip = nbir + beta * st.bip
        check = jnp.sqrt(dot(st.r, st.r)) / norm
        if debug:
            jax.debug.print("iter = {}, check = {}", st.i, check)
        conv = check < eps
        x = jnp.where(conv, st.x, st.x + alfa * st.p)
        hist = st.hist.at[st.i].set(check)
        return _BState(jnp.where(conv, st.i, st.i + 1),
                       jnp.where(conv, 1, 0).astype(jnp.int32),
                       x, nr, nbir, np_, nbip, check, hist)

    init = _BState(jnp.int32(0), jnp.int32(0), x, r, r, r, r,
                   jnp.asarray(jnp.inf, dt), jnp.full((maxit,), -1.0, dt))
    st = jax.lax.while_loop(cond, body, init)
    return st.x, st.status, st.i, st.check, norm, st.hist


def bicg(a, b, config: SolverConfig = DEFAULT_CONFIG,
         format: Optional[str] = None) -> SolveResult:
    """Solve Ax=b with plain BiCG, x0 = ones, relative-residual tolerance
    ``config.tol`` (reference EPSILON = 1e-6, bicstab.cpp:9), maxit
    ``config.maxit`` (reference :244)."""
    dt = jnp.dtype(config.dtype)
    t0 = time.perf_counter()
    if isinstance(a, CSRMatrix):
        op = make_operator(a, dtype=dt, format=format)
        op_t = make_operator(a.transpose(), dtype=dt, format=format)
    else:
        op, op_t = a  # pass a pair (op, op_transpose) of device operators
    bd = jnp.asarray(b, dt)
    t1 = time.perf_counter()
    x, status, iters, check, norm, hist = jax.block_until_ready(
        _bicg_solve(op, op_t, bd, jnp.asarray(config.tol, dt), config.maxit,
                    config.debug))
    t2 = time.perf_counter()
    st = SolverStatus.CONVERGED if int(status) == 1 else SolverStatus.MAXIT
    res = SolveResult(
        x=np.asarray(x), status=st, iters=int(iters), residual=float(check),
        residual0=float(norm), dt_alg=t2 - t1, dt_setup=t1 - t0,
        residual_history=np.asarray(hist))
    from cuda_mat.solvers.bicgstab import _attach_true_residual

    return _attach_true_residual(res, a, b, config)
