#!/usr/bin/env python
"""Headline benchmark: single-GPU SpMV throughput against a measured copy,
plus the solve arms.

Prints ONE JSON line to stdout:
    {"metric": "spmv_gbps_per_chip", "value": <GB/s>, "unit": "GB/s",
     "vs_baseline": <fraction of the measured copy>, ...solve metrics...,
     "device": {...}, "card": "<nvidia-smi name, power.limit>"}

The reference publishes no numbers (BASELINE.md); its protocol is solver-only
timing on the banded workloads.  The BASELINE.json target is >= 0.70 of
roofline SpMV throughput per chip, so ``vs_baseline`` is the achieved
fraction of a large device copy measured in the same process.  Every solve
arm reports the MEDIAN of 3 warm solves through one prepared solver (setup
and compilation excluded).  Details go to stderr.

Byte model for DIA SpMV: the operand-once model (ndiag*n + 2n) * itemsize —
each diagonal read once, x read once, y written once.

Runs only on a GPU: ``python bench.py`` exits non-zero elsewhere.
"""

import json
import subprocess
import sys
import time

import numpy as np


def card_name() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _chain_time(step_fn, x0, k=200, reps=5, args=()):
    """Median per-step time of a k-step *dependency chain* of ``step_fn``
    inside one jit: y_{i+1} = f(y_i) cannot be hoisted by XLA, and the
    launch cost is amortized over k steps."""
    import jax

    @jax.jit
    def run(x, *a):
        # extra operands ride as jit ARGUMENTS (pytrees), not closure
        # captures, which XLA would bake into the program as constants
        return jax.lax.fori_loop(0, k, lambda i, y: step_fn(y, *a), x)

    jax.block_until_ready(run(x0, *args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(x0, *args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / k


def _median_solve(solver, b, reps=3):
    """Median-of-``reps`` warm solves (first call also compiles; it is
    excluded).  Returns the median-dt_alg result."""
    solver.solve(b)                            # compile + warm
    rs = [solver.solve(b) for _ in range(reps)]
    rs.sort(key=lambda r: r.dt_alg)
    return rs[len(rs) // 2]


def _median_refined(a, b, cfg, inner_tol, solver, reps=3):
    from cuda_mat.solvers.refine import solve_refined

    rs = [solve_refined(a, b, cfg, inner_tol=inner_tol, solver=solver)
          for _ in range(reps)]
    rs.sort(key=lambda r: r.dt_alg)
    return rs[len(rs) // 2]


def main():
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX runs on {jax.default_backend()}",
              file=sys.stderr)
        sys.exit(1)
    from cuda_mat.config import SolverConfig
    from cuda_mat.io.mmio import load_mm_sparse_matrix
    from cuda_mat.models.problems import (banded_laplacian_dia,
                                          grid_laplacian,
                                          random_diag_nonzero_system)
    from cuda_mat.ops.operators import DIAOperator, make_operator
    from cuda_mat.ops.stencil import ConstStencilOperator
    from cuda_mat.parallel.dist_solver import make_dist_bicgstab
    from cuda_mat.parallel.mesh import make_mesh
    from cuda_mat.solvers.bicgstab import make_solver
    from cuda_mat.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    card = card_name()
    info = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}, "card": card}
    print(f"card: {card}", file=sys.stderr)

    # ---- measured copy (read + write), 1 GiB f32 — far beyond the L2 ------
    copy_elems = 256 * 1024 * 1024
    src = jnp.ones((copy_elems,), jnp.float32)
    t_copy = _chain_time(lambda y: y * 1.0000001 + 1.0, src, k=50)
    copy_gbps = 2 * copy_elems * 4 / t_copy / 1e9
    info["copy_gbps"] = copy_gbps
    del src

    # ---- DIA SpMV on the 10M-row banded Laplacian -------------------------
    dia = banded_laplacian_dia(3163, dtype=np.float32)
    n = dia.n
    op = DIAOperator(jnp.asarray(dia.data), tuple(int(o) for o in dia.offsets),
                     n)
    x = jnp.ones((n,), jnp.float32)
    # *0.1 keeps the chained iterates bounded (spectral radius < 1)
    t_spmv = _chain_time(lambda y, o: o.matvec(y) * 0.1, x, args=(op,))
    spmv_gbps = (dia.ndiag * n + 2 * n) * 4 / t_spmv / 1e9
    info.update(n=n, nnz=dia.nnz, t_spmv_us=t_spmv * 1e6,
                spmv_gbps=spmv_gbps, nnz_per_s=dia.nnz / t_spmv)

    # ---- matrix-free constant stencil (gap-strided layout) ----------------
    sop = ConstStencilOperator.from_dia(dia)
    xs = sop.pad_vec(jnp.ones((n,), jnp.float32))
    t_sten = _chain_time(lambda y, o: o.matvec(y) * 0.1, xs, args=(sop,))
    info.update(t_stencil_us=t_sten * 1e6,
                stencil_nnz_per_s=sop.nnz / t_sten,
                stencil_vs_dia=t_spmv / t_sten)
    del op, x, sop, xs

    # ---- mat10000 / mat900 exact-ILU solves (reference workloads) ---------
    a = load_mm_sparse_matrix("data/mat10000.mtx")
    b = np.ones(a.n)
    cfg = SolverConfig(maxit=2000, tol=1e-4, dtype="float32", precond="ilu0",
                       trisolve_block=128)
    res = _median_solve(make_solver(a, cfg), b)
    info.update(mat10000_iters=res.iters, mat10000_dt_alg_ms=res.dt_alg * 1e3,
                mat10000_status=res.status.name)
    a9 = load_mm_sparse_matrix("data/mat900.mtx")
    r9 = _median_solve(make_solver(a9, cfg), np.ones(a9.n))
    info.update(mat900_iters=r9.iters, mat900_dt_alg_ms=r9.dt_alg * 1e3,
                mat900_status=r9.status.name)

    # ---- BELL / dense / ELL matvecs on the reference CLI's random system
    # (n=10000, P(zero)=0.99, example.cpp:173-175,274-286)
    ar, _ = random_diag_nonzero_system(10000, 0.99, seed=0)
    xr = jnp.ones((ar.n,), jnp.float32)
    for fmt in ("bell", "dense", "ell"):
        opf = make_operator(ar, dtype=jnp.float32, format=fmt)
        t_mv = _chain_time(lambda y, o: o.matvec(y) * 1e-3, xr, k=100,
                           args=(opf,))
        info[f"{fmt}_matvec_us"] = t_mv * 1e6

    # ---- mat10000 at the REFERENCE protocol (example.cpp:179-180:
    # maxit=2000, tol=1e-6 in true f64 residual terms) — f32 inner solves +
    # f64 host residual correction, through ONE prepared solver
    cfg6 = SolverConfig(maxit=2000, tol=1e-4, dtype="float32",
                        precond="ilu0_neumann", neumann_terms=3)
    ps6 = make_solver(a, cfg6)
    ps6.solve(b)                                   # compile
    rr = _median_refined(a, b, cfg6.replace(tol=1e-6), 1e-4, ps6)
    info.update(mat10000_refined_rel_residual=rr.residual / rr.residual0,
                mat10000_refined_ms=rr.dt_alg * 1e3,
                mat10000_refined_iters=rr.iters,
                mat10000_refined_status=rr.status.name)

    # ---- 1M-row Neumann solve + refined to 1e-6 ---------------------------
    a1 = grid_laplacian(10000, 100)
    b1 = np.ones(a1.n)
    cfg1 = SolverConfig(maxit=2000, tol=1e-4, dtype="float32",
                        precond="ilu0_neumann", neumann_terms=3)
    ps1 = make_solver(a1, cfg1)
    r1m = _median_solve(ps1, b1)
    info.update(solve_1m_ms=r1m.dt_alg * 1e3, solve_1m_iters=r1m.iters,
                solve_1m_status=r1m.status.name)
    rref = _median_refined(a1, b1, cfg1.replace(tol=1e-6), 1e-4, ps1)
    info.update(refined_rel_residual=rref.residual / rref.residual0,
                refined_ms=rref.dt_alg * 1e3, refined_status=rref.status.name)

    # ---- 10M-row flagship: stencil matvec + fused Neumann series (k=4) ----
    a10 = grid_laplacian(100000, 100)
    b10 = np.ones(a10.n)
    cfg10 = SolverConfig(maxit=2000, tol=1e-4, dtype="float32",
                         precond="ilu0_neumann", neumann_terms=4)
    ps10 = make_solver(a10, cfg10)
    r10 = _median_solve(ps10, b10)
    info.update(solve_10m_ms=r10.dt_alg * 1e3, solve_10m_iters=r10.iters,
                solve_10m_status=r10.status.name)
    rr10 = _median_refined(a10, b10, cfg10.replace(tol=1e-6), 1e-4, ps10)
    info.update(
        solve_10m_refined_rel_residual=rr10.residual / rr10.residual0,
        solve_10m_refined_ms=rr10.dt_alg * 1e3,
        solve_10m_refined_iters=rr10.iters,
        solve_10m_refined_status=rr10.status.name)
    # relaxed-MILU arm (beyond-reference preconditioner option): same
    # compiled graph as cfg10 — only the factor values change
    cfg10m = cfg10.replace(milu_omega=0.96)
    ps10m = make_solver(a10, cfg10m)
    r10m = _median_solve(ps10m, b10)
    info.update(solve_10m_milu_ms=r10m.dt_alg * 1e3,
                solve_10m_milu_iters=r10m.iters,
                solve_10m_milu_status=r10m.status.name)
    rrm = _median_refined(a10, b10, cfg10m.replace(tol=1e-6), 1e-4, ps10m)
    info.update(
        solve_10m_milu_refined_rel_residual=rrm.residual / rrm.residual0,
        solve_10m_milu_refined_ms=rrm.dt_alg * 1e3,
        solve_10m_milu_refined_iters=rrm.iters,
        solve_10m_milu_refined_status=rrm.status.name)

    # ---- distributed engine on a mesh(1): shard_map/ppermute/psum --------
    mesh1 = make_mesh(1)
    rd = _median_solve(make_dist_bicgstab(a1, mesh1, cfg1), b1)
    info.update(dist_stencil_1m_ms=rd.dt_alg * 1e3,
                dist_stencil_1m_iters=rd.iters,
                dist_stencil_1m_status=rd.status.name)
    dsolver10 = make_dist_bicgstab(a10, mesh1, cfg10m)
    rd10 = _median_solve(dsolver10, b10)
    info.update(dist_stencil_10m_milu_ms=rd10.dt_alg * 1e3,
                dist_stencil_10m_milu_iters=rd10.iters,
                dist_stencil_10m_milu_status=rd10.status.name)
    rdr = _median_refined(a10, b10, cfg10m.replace(tol=1e-6), 1e-4,
                          dsolver10)
    info.update(dist_10m_refined_rel_residual=rdr.residual / rdr.residual0,
                dist_10m_refined_ms=rdr.dt_alg * 1e3,
                dist_10m_refined_iters=rdr.iters,
                dist_10m_refined_status=rdr.status.name)

    print(json.dumps(info), file=sys.stderr)
    out = {
        "metric": "spmv_gbps_per_chip",
        "value": spmv_gbps,
        "unit": "GB/s",
        "vs_baseline": spmv_gbps / copy_gbps,
    }
    for k in ("copy_gbps", "stencil_nnz_per_s", "stencil_vs_dia",
              "solve_1m_ms", "solve_10m_ms", "solve_10m_milu_ms",
              "solve_10m_milu_refined_rel_residual",
              "solve_10m_milu_refined_ms",
              "solve_10m_refined_rel_residual",
              "solve_10m_refined_ms", "refined_rel_residual", "refined_ms",
              "mat10000_dt_alg_ms", "mat10000_refined_rel_residual",
              "mat10000_refined_ms", "mat900_dt_alg_ms",
              "bell_matvec_us", "dense_matvec_us", "ell_matvec_us",
              "dist_stencil_1m_ms", "dist_stencil_10m_milu_ms",
              "dist_10m_refined_rel_residual", "dist_10m_refined_ms",
              "device", "card"):
        out[k] = info[k]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
