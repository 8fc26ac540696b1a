"""Distributed SpMV and BiCGSTAB over a 1-D device mesh.

The whole solver loop runs inside one ``shard_map`` region under ``jit``:

- **SpMV**: each shard's banded block multiplies an extended local x built
  from two neighbor ``ppermute`` exchanges of w-element halo segments (the
  SURVEY §2 "halo-exchange collective"; XLA hands the ppermutes to the
  interconnect and can overlap them with the local diagonals).
- **Dots/norms**: local partial + ``lax.psum`` — replacing every
  ``cublasDdot``/``Dnrm2`` host sync of the reference (pbicgstab.cu:81,106,
  111,135-136,142) with an on-device replicated scalar.
- The scalar recurrences and convergence branches are the *same code* as the
  single-chip path (:func:`cuda_mat.solvers.bicgstab.hform_core` /
  :func:`precond_core`), closed over the distributed matvec/dot.
- Loop vectors are the partition-padded ``(npad,)`` vectors, sharded by
  rows; the padding is a fixed point of every engine and of the BLAS1 ops.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuda_mat.config import SolverConfig, DEFAULT_CONFIG
from cuda_mat.parallel.mesh import ROWS_AXIS
from cuda_mat.parallel.partition import RowPartitionedBanded
from cuda_mat.solvers.bicgstab import dot, hform_core, precond_core
from cuda_mat.solvers.result import SolveResult, SolverStatus

shard_map = jax.shard_map


def _make_local_matvec(offsets, halo, shard_rows, ndev, axis=ROWS_AXIS,
                       overlap: bool = True):
    """Build the per-shard banded matvec with neighbor halo exchange.

    Non-circular ppermute: edge devices receive zeros for the missing
    neighbor, which is exactly the global boundary condition (row-aligned DIA
    data is already zero where a diagonal runs off the matrix edge).

    ``overlap=True`` (default, requires shard_rows >= 2*halo) computes the
    interior rows ``[w, s-w)`` — which read only local x — as a separate
    dependency chain from the ppermutes, so XLA's latency-hiding scheduler
    can run the halo exchange *during* the bulk of the multiply
    (SURVEY §2 "overlapped with local-block SpMV").  The per-row operations
    and their order are identical to the unsplit form, so results match
    bitwise."""
    w = halo
    s = shard_rows
    send_right = [(i, i + 1) for i in range(ndev - 1)]
    send_left = [(i + 1, i) for i in range(ndev - 1)]
    split = overlap and w > 0 and ndev > 1 and s >= 2 * w

    def matvec(data_local, xl):
        if not split:
            x_ext = _halo_extend(xl, w, axis, ndev)
            y = jnp.zeros(s, xl.dtype)
            for k, off in enumerate(offsets):
                y = y + data_local[k] * jax.lax.dynamic_slice(
                    x_ext, (w + off,), (s,))
            return y
        left_halo = jax.lax.ppermute(xl[-w:], axis, send_right)
        right_halo = jax.lax.ppermute(xl[:w], axis, send_left)
        # interior rows [w, s-w): row+off stays inside [0, s) for |off| <= w
        y_int = jnp.zeros(s - 2 * w, xl.dtype)
        for k, off in enumerate(offsets):
            y_int = y_int + data_local[k, w: s - w] * jax.lax.dynamic_slice(
                xl, (w + off,), (s - 2 * w,))
        # boundary rows: [0, w) reads x_ext rows [-w, 2w); [s-w, s) reads
        # [s-2w, s+w) — each needs one halo plus a 2w-deep local edge
        xe_l = jnp.concatenate([left_halo, xl[: 2 * w]])
        xe_r = jnp.concatenate([xl[s - 2 * w:], right_halo])
        y_l = jnp.zeros(w, xl.dtype)
        y_r = jnp.zeros(w, xl.dtype)
        for k, off in enumerate(offsets):
            y_l = y_l + data_local[k, :w] * jax.lax.dynamic_slice(
                xe_l, (w + off,), (w,))
            y_r = y_r + data_local[k, s - w:] * jax.lax.dynamic_slice(
                xe_r, (w + off,), (w,))
        return jnp.concatenate([y_l, y_int, y_r])

    return matvec


def _halo_extend(xl: jax.Array, w: int, axis, ndev: int) -> jax.Array:
    """``[left halo | xl | right halo]`` with w-element halos from the
    neighbor shards (zeros past the global ends — non-circular ppermute
    leaves edge devices without a partner, which is exactly the boundary
    condition)."""
    if w == 0:
        return xl
    if ndev == 1:
        return jnp.pad(xl, (w, w))
    left = jax.lax.ppermute(xl[-w:], axis,
                            [(i, i + 1) for i in range(ndev - 1)])
    right = jax.lax.ppermute(xl[:w], axis,
                             [(i + 1, i) for i in range(ndev - 1)])
    return jnp.concatenate([left, xl, right])


def _make_local_matvec_stencil(part, axis, sterms=None):
    """Per-shard matvec of the gap-strided constant stencil
    (:func:`cuda_mat.ops.stencil.shifted_sum` over the halo-extended shard,
    then the gap mask and the mask of the partition's padding rows, by
    global grid row).  ``sterms``: another stencil on A's layout (the
    Neumann-series polynomials), default A's own terms.  The coefficients are
    compile-time scalars, so the only sharded state is x itself.  Replaces
    reference pbicgstab.cu:104,132.

    Every row waits for the two halo ppermutes.  An interior/boundary split
    (every row from local x during the exchange, the w end rows rewritten
    afterwards) measured no faster on four H100s, and XLA's schedule did not
    put its main pass inside the exchange (PERF.md, Findings)."""
    from cuda_mat.ops.stencil import gap_mask, shifted_sum

    sterms = part.strided_terms if sterms is None else sterms
    w = max(abs(o) for o, _ in sterms)
    s = part.shard_rows
    if w > s:
        raise ValueError(f"stencil halo {w} exceeds shard size {s}")
    rows_per_shard = s // part.stride

    def matvec(xl):
        y = shifted_sum(_halo_extend(xl, w, axis, part.ndev), sterms, s,
                        base=w)
        row0 = jax.lax.axis_index(axis) * rows_per_shard
        return gap_mask(y, part.c_grid, part.stride, row0=row0,
                        rows=part.rows)

    return matvec


def _make_local_msolve_stencil(part, axis, sterms_l, sterms_u):
    """Per-shard Neumann msolve with interior-constant factors,
    ``x = P_u (inv_d ∘ P_l f)``: each triangle's whole truncated series is
    one stencil on A's layout (``sterms_l``/``sterms_u``), applied by
    :func:`_make_local_matvec_stencil` with its own halo exchange.  Same
    expansion as the single-chip :meth:`NeumannILUPreconditioner.msolve`."""
    pl = _make_local_matvec_stencil(part, axis, sterms=sterms_l)
    pu = _make_local_matvec_stencil(part, axis, sterms=sterms_u)

    def msolve(inv_d, f):
        return pu(inv_d * pl(f))

    return msolve


def _psum_dot(axis=ROWS_AXIS):
    def psum_dot(u, v):
        return jax.lax.psum(dot(u, v), axis)

    return psum_dot


def put_global(host_array: np.ndarray, sharding) -> jax.Array:
    """``device_put`` that also works when the sharding spans multiple
    processes (multi-host mesh): every process holds the full host array and
    contributes its addressable shards (SURVEY §2 distributed component 4 —
    the multi-host runtime path)."""
    if jax.process_count() > 1:
        return jax.make_array_from_callback(
            host_array.shape, sharding, lambda idx: host_array[idx])
    return jax.device_put(jnp.asarray(host_array), sharding)


def fetch_global(arr: jax.Array) -> np.ndarray:
    """Materialize a (possibly cross-process) sharded array on every host."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
    return np.asarray(arr)


def make_dist_spmv(part, mesh: Mesh, dtype=jnp.float32,
                   local_engine: str = "xla"):
    """Jitted distributed SpMV ``y = A x`` over sharded (npad,) vectors.

    ``local_engine``: "xla" = shifted-slice banded formulation over a
    :class:`~cuda_mat.parallel.partition.RowPartitionedBanded`; "stencil" =
    the gap-strided constant stencil over a
    :class:`~cuda_mat.parallel.partition.RowPartitionedStencil`.

    Returns ``(fn, put)`` where ``put(v)`` shards a host vector and
    ``fn(x_sharded)`` computes the product (used by tests and the weak-scaling
    bench); recover the true vector with ``part.unpad_vector``."""
    axis = mesh.axis_names[0]
    vec_sharding = NamedSharding(mesh, P(axis))
    if local_engine == "stencil":
        data = ()
        data_specs = ()
        mv_st = _make_local_matvec_stencil(part, axis)
        local_mv = lambda d, xl: mv_st(xl)  # noqa: E731
    elif local_engine == "xla":
        data = (put_global(np.asarray(part.data, np.dtype(dtype)),
                           NamedSharding(mesh, P(None, axis))),)
        data_specs = (P(None, axis),)
        mv_stacked = _make_local_matvec(part.offsets, part.halo,
                                        part.shard_rows, part.ndev, axis)
        local_mv = lambda d, xl: mv_stacked(d[0], xl)  # noqa: E731
    else:
        raise ValueError(f"unknown local_engine {local_engine!r}")

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(data_specs, P(axis)),
             out_specs=P(axis))
    def spmv(data_l, xl):
        return local_mv(data_l, xl)

    def put(v: np.ndarray):
        vp = np.asarray(part.pad_vector(np.asarray(v)), np.dtype(dtype))
        return put_global(vp, vec_sharding)

    return (lambda x: spmv(data, x)), put


def dist_spmv(a, x: np.ndarray, mesh: Mesh, dtype=jnp.float64,
              local_engine: str = "xla") -> np.ndarray:
    """One-shot distributed SpMV for a host matrix/vector (convenience)."""
    if local_engine == "stencil":
        from cuda_mat.parallel.partition import RowPartitionedStencil

        part = RowPartitionedStencil.from_matrix(a, mesh.devices.size)
    else:
        part = RowPartitionedBanded.from_matrix(a, mesh.devices.size)
    fn, put = make_dist_spmv(part, mesh, dtype, local_engine)
    return part.unpad_vector(fetch_global(fn(put(x))))


class DistBicgstabSolver:
    """A prepared (partitioned + jitted) distributed solver.

    Built once by :func:`make_dist_bicgstab`; :meth:`solve` may then be
    called for any number of right-hand sides without re-tracing or
    re-compiling (the jitted ``run`` closure is cached on this object —
    one-shot :func:`dist_bicgstab` pays the trace+compile on every call).
    Mirrors the reference's setup/solve phase split (pbicgstab.cu:335-363
    vs :366)."""

    def __init__(self, a, part, run, mat_args, inv_diag, tol, btol,
                 tri_stacked, fac_args, vec_sharding, dt, config, dt_setup):
        self.a = a
        self.part = part
        self._run = run
        self._mat_args = mat_args
        self._inv_diag = inv_diag
        self._tol = tol
        self._btol = btol
        self._tri_stacked = tri_stacked
        self._fac_args = fac_args
        self._vec_sharding = vec_sharding
        self._dt = dt
        self._config = config
        self.dt_setup = dt_setup

    def _put_vec(self, v: np.ndarray) -> jax.Array:
        vp = np.asarray(self.part.pad_vector(np.asarray(v)), self._dt)
        return put_global(vp, self._vec_sharding)

    def solve(self, b: np.ndarray,
              x0: Optional[np.ndarray] = None) -> SolveResult:
        part = self.part
        bp = self._put_vec(b)
        # reference x0 = ones (pbicgstab.cu:827-832)
        x0p = self._put_vec(np.ones(part.n) if x0 is None else x0)
        # dtAlg excludes H2D transfers (reference pbicgstab.h:108-109):
        # finish the uploads before the solve timer starts, exactly like the
        # single-chip wrappers
        jax.block_until_ready((bp, x0p))
        t1 = time.perf_counter()
        out = jax.block_until_ready(self._run(
            *self._mat_args, x0p, bp, self._inv_diag, self._tol, self._btol,
            *self._tri_stacked, *self._fac_args))
        t2 = time.perf_counter()
        x, status, iters, nrmr, nrmr0, hist = out
        status = int(np.asarray(status).reshape(-1)[0])
        if status == 0:
            status = SolverStatus.MAXIT
        res = SolveResult(
            x=part.unpad_vector(fetch_global(x)),
            status=SolverStatus(status),
            iters=int(np.asarray(iters).reshape(-1)[0]),
            residual=float(np.asarray(nrmr).reshape(-1)[0]),
            residual0=float(np.asarray(nrmr0).reshape(-1)[0]),
            dt_alg=t2 - t1, dt_setup=self.dt_setup,
            residual_history=np.asarray(hist).reshape(-1))
        from cuda_mat.solvers.bicgstab import _attach_true_residual

        return _attach_true_residual(res, self.a, b, self._config)


def dist_bicgstab(a, b: np.ndarray, mesh: Mesh,
                  config: SolverConfig = DEFAULT_CONFIG,
                  x0: Optional[np.ndarray] = None,
                  halo_mode: str = "auto",
                  local_engine: str = "auto") -> SolveResult:
    """One-shot row-partitioned BiCGSTAB over the mesh (partition + compile +
    solve; use :func:`make_dist_bicgstab` to reuse the compiled solver across
    right-hand sides)."""
    return make_dist_bicgstab(a, mesh, config, halo_mode,
                              local_engine).solve(b, x0)


def make_dist_bicgstab(a, mesh: Mesh,
                       config: SolverConfig = DEFAULT_CONFIG,
                       halo_mode: str = "auto",
                       local_engine: str = "auto") -> DistBicgstabSolver:
    """Partition ``a``, build the preconditioner state, and jit the solver
    loop for row-partitioned BiCGSTAB over the mesh.

    ``config.precond``: "none" runs the h-form loop (parity with
    :func:`cuda_mat.solvers.bicgstab.bicgstab`); "jacobi" runs the
    preconditioned loop with a sharded diagonal; "bjacobi_ilu0" runs it with
    the block-Jacobi ILU(0) preconditioner (per-shard local ILU solves, zero
    communication per application — see
    :mod:`cuda_mat.parallel.dist_precond`); "ilu0_neumann" applies the
    *global* ILU(0) factor through its truncated Neumann series — each term
    is a banded SpMV of N_l/N_u, row-partitioned exactly like A and applied
    through the same halo-exchange machinery, so the preconditioner
    distributes with no new communication pattern.  Exact global ILU(0) is a
    sequential recurrence — use the single-chip path for that.

    ``halo_mode``: "auto" picks neighbor-ppermute halos for banded matrices
    and an all-gather of x for general sparsity; "ppermute"/"allgather" force
    one (SURVEY §5 "ppermute/all-gather for halo x segments").

    ``local_engine``: the per-shard SpMV — "xla" (shifted slices of the DIA
    data), "stencil" (the matrix-free gap-strided constant stencil; requires
    a constant-coefficient grid stencil and precond none/jacobi/ilu0_neumann),
    or "auto" (stencil when :func:`~cuda_mat.ops.selection.select_format`
    proves the structure and the preconditioner allows it, else xla).
    """
    from cuda_mat.formats.csr import CSRMatrix
    from cuda_mat.ops.selection import check_platform, select_format

    t0 = time.perf_counter()
    check_platform()
    dt = jnp.dtype(config.dtype)
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size

    mode = config.precond or "none"
    if mode == "identity":
        mode = "none"
    if mode not in ("none", "jacobi", "bjacobi_ilu0", "ilu0_neumann"):
        raise ValueError(
            f"distributed solver supports precond none/jacobi/bjacobi_ilu0/"
            f"ilu0_neumann, got {config.precond!r}")
    if local_engine not in ("auto", "xla", "stencil"):
        raise ValueError(f"unknown local_engine {local_engine!r}")
    # the stencil's strided coordinates compose with none/jacobi/ilu0_neumann
    # (bjacobi_ilu0's blocked trisolve works in true coordinates)
    stencil_ok = mode != "bjacobi_ilu0" and halo_mode != "allgather"
    if local_engine == "stencil" and not stencil_ok:
        raise ValueError("local_engine='stencil' requires ppermute halos and"
                         " precond none/jacobi/ilu0_neumann")
    stencil = local_engine == "stencil" or (
        local_engine == "auto" and stencil_ok and isinstance(a, CSRMatrix)
        and select_format(a)[0] == "stencil")
    const_series = (stencil and mode == "ilu0_neumann"
                    and config.neumann_const_factors)

    banded = None
    if stencil:
        from cuda_mat.ops.stencil import series_gap
        from cuda_mat.parallel.partition import RowPartitionedStencil

        dia = a.to_dia(max_diags=128) if isinstance(a, CSRMatrix) else a
        part = RowPartitionedStencil.from_matrix(dia, ndev)
        if const_series:
            # widen the gap so each triangle's whole series is one stencil
            gap = series_gap(part.terms, config.neumann_terms)
            if gap > part.stride - part.c_grid:
                part = RowPartitionedStencil.from_matrix(dia, ndev, gap=gap)
        banded = True
    elif halo_mode in ("auto", "ppermute"):
        try:
            part = RowPartitionedBanded.from_matrix(a, ndev)
            banded = True
        except ValueError:
            if halo_mode == "ppermute":
                raise
    if banded is None:
        from cuda_mat.parallel.partition import RowPartitionedELL

        part = RowPartitionedELL.from_matrix(a, ndev)
        banded = False
    vec_sharding = NamedSharding(mesh, P(axis))

    def put_diagvec(v):
        """Shard a partition-padded diagonal stream."""
        return put_global(np.asarray(v, dt), vec_sharding)

    if stencil:
        mat_args = ()
        mat_specs = ()
        mv_stencil = _make_local_matvec_stencil(part, axis)

        def make_mv(mat_l):
            return mv_stencil

        # a constant stencil's diagonal is its offset-0 scalar everywhere
        # (dc=0 never leaves the grid); gap/tail cells get 1 (the vectors
        # there are exact zeros either way)
        d0 = next((t[2] for t in part.terms if t[0] == 0), 0.0)
        diag = part.strided_scatter(np.full(part.n, d0), fill=1.0)
    elif banded:
        mat_args = (put_global(np.asarray(part.data, dt),
                               NamedSharding(mesh, P(None, axis))),)
        mat_specs = (P(None, axis),)
        local_mv_banded = _make_local_matvec(part.offsets, part.halo,
                                             part.shard_rows, ndev, axis)

        def make_mv(mat_l):
            return lambda xl: local_mv_banded(mat_l[0], xl)

        diag = part.data[part.offsets.index(0)]
    else:
        mat_args = (put_global(np.asarray(part.values, dt),
                               NamedSharding(mesh, P(axis, None))),
                    put_global(np.asarray(part.cols),
                               NamedSharding(mesh, P(axis, None))))
        mat_specs = (P(axis, None), P(axis, None))

        def make_mv(mat_l):
            vals_l, cols_l = mat_l

            def mv(xl):
                xg = jax.lax.all_gather(xl, axis, axis=0, tiled=True)
                return jnp.sum(vals_l * jnp.take(xg, cols_l, axis=0), axis=1)

            return mv

        diag = part.diag

    psum_dot = _psum_dot(axis)
    tol = jnp.asarray(config.tol, dt)
    btol = jnp.asarray(config.breakdown_tol, dt)
    fac_args = []
    fac_specs = []
    fac_mvs = []
    fac_fused = False
    if mode == "jacobi":
        if np.any(diag == 0):
            raise ValueError("Jacobi preconditioner requires a nonzero diagonal")
        inv_diag = put_diagvec(1.0 / diag)
    elif mode == "ilu0_neumann":
        if not banded:
            raise ValueError("ilu0_neumann requires a banded (DIA) partition;"
                             " use jacobi for general sparsity")
        if not isinstance(a, CSRMatrix):
            # neumann_factors needs the CSR pattern (row_lengths/indices)
            raise ValueError(
                "ilu0_neumann needs a CSRMatrix input (the ILU(0)"
                f" factorization runs on the CSR pattern); got {type(a).__name__}")
        from cuda_mat.precond.preconditioners import neumann_factors

        low, up, diag_m = neumann_factors(a, config.milu_omega)
        if const_series:
            # interior-constant factors, each triangular series collapsed
            # into ONE matrix-free stencil (see NeumannILUPreconditioner):
            # no factor data to shard at all; same layout as A
            from cuda_mat.ops.stencil import (const_factor_terms,
                                              neumann_poly_terms,
                                              strided_offsets)

            try:
                polys = []
                for f in (low, up):
                    t, _ = const_factor_terms(f.to_dia(max_diags=128),
                                              part.c_grid, part.stride)
                    pt = neumann_poly_terms(t, config.neumann_terms,
                                            part.c_grid, part.stride)
                    polys.append(strided_offsets(pt, part.c_grid,
                                                 part.stride))
                msolve_fused = _make_local_msolve_stencil(part, axis, *polys)
                fac_fused = True
            except ValueError:
                pass
        for f in () if fac_fused else (low, up):
            if stencil:
                # re-index the exact factor into the stencil's gap-strided
                # coordinates; the restrided DIA data's zero slots mask the
                # gaps, so they stay a fixed point of each term (mirrors
                # NeumannILUPreconditioner.from_csr pad_like)
                from cuda_mat.ops.stencil import restride_dia

                fd = restride_dia(f.to_dia(max_diags=128), part.c_grid,
                                  part.stride)
                pf = RowPartitionedBanded.from_matrix(fd, ndev,
                                                      align=part.shard_rows)
            else:
                pf = RowPartitionedBanded.from_matrix(f, ndev)
            if pf.npad != part.npad or pf.shard_rows != part.shard_rows:
                raise ValueError("factor partition does not match A's")
            fac_args.append(put_global(np.asarray(pf.data, dt),
                                       NamedSharding(mesh, P(None, axis))))
            fac_specs.append(P(None, axis))
            mv_x = _make_local_matvec(pf.offsets, pf.halo, pf.shard_rows,
                                      ndev, axis)
            fac_mvs.append(lambda d, xl, _mv=mv_x: _mv(d, xl))
        if stencil:
            invd = part.strided_scatter(1.0 / diag_m, fill=1.0)
        else:
            invd = np.ones(part.npad)
            invd[: part.n] = 1.0 / diag_m
        inv_diag = put_diagvec(invd)
    else:
        inv_diag = put_diagvec(np.ones(part.npad))

    if mode == "bjacobi_ilu0":
        if not banded:
            raise ValueError("bjacobi_ilu0 requires a banded (DIA) partition;"
                             " use jacobi for general sparsity")
        from cuda_mat.parallel.dist_precond import (
            build_block_jacobi_ilu, local_solver_from_stacked)

        tb = min(config.trisolve_block, part.shard_rows)
        stacked = build_block_jacobi_ilu(part, tb, dt,
                                         milu_omega=config.milu_omega)
        shard_leading = NamedSharding(mesh, P(axis))
        tri_stacked = tuple(put_global(np.asarray(s), shard_leading)
                            for s in stacked)
        tri_specs = (P(axis),) * 6
    else:
        tb = 0
        tri_stacked = ()
        tri_specs = ()

    maxit, debug = config.maxit, config.debug
    check_halves = config.check_halves
    nterms = config.neumann_terms
    n_mat = len(mat_args)
    n_tri = len(tri_stacked)

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=mat_specs + (P(axis), P(axis), P(axis), P(), P())
             + tri_specs + tuple(fac_specs),
             out_specs=(P(axis), P(), P(), P(), P(), P()))
    def run(*args):
        mat_l = args[:n_mat]
        x0_l, b_l, inv_diag_l, tol_, btol_ = args[n_mat:n_mat + 5]
        tri_l = args[n_mat + 5: n_mat + 5 + n_tri]
        fac_l = args[n_mat + 5 + n_tri:]
        mv = make_mv(mat_l)
        if mode == "jacobi":
            msolve = lambda f: inv_diag_l * f  # noqa: E731
        elif mode == "bjacobi_ilu0":
            msolve = local_solver_from_stacked(*tri_l, part.shard_rows,
                                               tb).msolve
        elif mode == "ilu0_neumann" and fac_fused:
            msolve = partial(msolve_fused, inv_diag_l)
        elif mode == "ilu0_neumann":
            nl_mv, nu_mv = fac_mvs
            nl_data, nu_data = fac_l

            def msolve(f):
                # truncated series L^-1 ~ sum (-N_l)^j, U^-1 ~ sum (-N_u)^j D^-1
                # — same update order as the single-chip
                # NeumannILUPreconditioner.msolve, every term a halo-exchange
                # banded SpMV
                y = f
                term = f
                for _ in range(nterms - 1):
                    term = -nl_mv(nl_data, term)
                    y = y + term
                g = inv_diag_l * y
                x = g
                term = g
                for _ in range(nterms - 1):
                    term = -nu_mv(nu_data, term)
                    x = x + term
                return x
        else:
            return hform_core(mv, psum_dot, x0_l, b_l, tol_, btol_, maxit,
                              debug)
        return precond_core(mv, msolve, psum_dot, x0_l, b_l, tol_, maxit,
                            debug, check_halves=check_halves)

    return DistBicgstabSolver(a, part, run, mat_args, inv_diag, tol, btol,
                              tri_stacked, fac_args, vec_sharding, dt,
                              config, time.perf_counter() - t0)
