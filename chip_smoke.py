#!/usr/bin/env python
"""On-card smoke test: the solver's main path, end to end, on NVIDIA GPUs.

    python chip_smoke.py            # phases 1-4 on one GPU
    python chip_smoke.py --multi    # phase 5 only: distributed solves, 4 GPUs
    python chip_smoke.py --out FILE # also write every record as JSON

Phases (each at real widths, each check with the tolerance printed beside
the measured value; PERF.md justifies every tolerance):

1. every device operator the main path uses, against a float64 host
   reference (numpy/scipy) at real widths, with its warm time, GB/s and
   share of a large device copy measured in the same process;
2. the reference path: float64 ILU(0)-preconditioned BiCGSTAB on the bundled
   mat10000/mat900 fixtures against the iteration-count goldens, then the
   CLI in-process;
3. the flagship: the 10M-row 5-point Laplacian, float32 Neumann-ILU(0)
   solve (with and without relaxed MILU), then refined to 1e-6 in true
   float64 residual terms;
4. the distributed engine on a one-device mesh against the single-card
   solve;
5. (``--multi``) the distributed solves on a 4-device mesh against the
   single-card solves of the same configurations.

Everything runs in this one process: a second JAX process could not open the
card (the first reserves most of its memory).  The script refuses to run
without a GPU, exits non-zero when any phase fails, and prints as its last
line ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``
only when every phase passed.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FLAGSHIP_GRID = (100000, 100)     # 10M rows, the flagship solve
ONE_M_GRID = (10000, 100)         # 1M rows
L2_BYTES = 50 * 10**6             # H100 L2 cache
COPY_ELEMS = 256 * 2**20          # 1 GiB of f32 per direction, > 20x the L2

# tolerances (PERF.md "Tolerances" gives the reasoning for each)
TOL_MATVEC_F32 = 1e-6      # max|y - y64| / max(|A||x|): f32 rounding ~6e-8
TOL_MSOLVE_F32 = 1e-5      # ||y - y64|| / ||y64||: ~20 rounded f32 steps
TOL_DENSE_F32 = 1e-5       # ||y - y64|| / ||y64||: TF32 would give ~1e-3
TOL_TRI_F32 = 2e-5         # ||x - x64|| / ||x64||: TF32 would give ~1e-3
TOL_TRI_F64 = 1e-10        # block-inverse rounding in f64
TOL_TRUE_RES = 1e-6        # the reference convergence contract
TOL_X_DIST = 1e-3          # ||x_dist - x_single|| / ||x_single||, tol 1e-4 solves


class PhaseFailure(Exception):
    pass


class Smoke:
    """Records of one run: every number printed is also kept for --out.
    Failed checks are collected, so one run reports every failure of a
    phase; the phase fails at its end (:meth:`end_phase`)."""

    def __init__(self, card):
        self.card = card
        self.records = []
        self.failures = []

    def check(self, cond, msg):
        if not cond:
            print(f"CHECK FAILED: {msg}", flush=True)
            self.failures.append(msg)

    def end_phase(self):
        failures, self.failures = self.failures, []
        if failures:
            raise PhaseFailure("; ".join(failures))

    def report(self, phase, name, **vals):
        rec = dict(phase=phase, name=name, card=self.card, **vals)
        self.records.append(rec)
        body = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in vals.items())
        print(f"[{self.card}] {phase} {name}: {body}", flush=True)


def card_lines():
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def chain_time(step, x0, k=20, reps=5, args=()):
    """Warm seconds per application of ``step`` in a k-long dependency chain
    inside one jit (launch cost amortized; compilation excluded)."""
    import jax

    @jax.jit
    def run(x, *a):
        return jax.lax.fori_loop(0, k, lambda i, y: step(y, *a), x)

    jax.block_until_ready(run(x0, *args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(x0, *args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / k


def chain_scale(fn, x, iters=30):
    """0.9 / (power-iteration estimate of fn's spectral radius): a chain of
    ``fn(y) * scale`` stays bounded."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(fn)
    y = x / jnp.linalg.norm(x)
    rho = 1.0
    for _ in range(iters):
        y = f(y)
        rho = float(jnp.linalg.norm(y))
        y = y / rho
    return 0.9 / rho


_TRIVIAL_OPS = {"parameter", "constant", "tuple", "get-tuple-element",
                "bitcast"}


_OP_RE = r"=\s*(?:\(.*?\)|\S+)\s+([a-z][\w\-]*)\("


def hlo_computations(fn, *args):
    """``{computation name: instruction lines}`` of ``fn``'s optimized HLO
    (the entry computation under "ENTRY"; a scheduled module lists each
    computation's instructions in the order they run)."""
    import re

    import jax

    txt = jax.jit(fn).lower(*args).compile().as_text()
    comps, name = {}, None
    for line in txt.splitlines():
        head = re.match(r"^(ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if head and not line.startswith(" "):
            name = "ENTRY" if head.group(1) else head.group(2)
            comps[name] = []
        elif name and line.startswith("  "):
            comps[name].append(line)
    return comps


def hlo_kernels(fn, *args):
    """Kernels XLA emits for one call of ``fn`` (optimized HLO): the
    device-side instructions of the entry computation (fusions, library
    calls, copies) and, per while loop in it, those of the loop body — the
    launches one iteration makes."""
    import re

    comps = hlo_computations(fn, *args)
    op_re = re.compile(_OP_RE)

    def count(lines):
        ops = [m.group(1) for m in map(op_re.search, lines) if m]
        return sum(1 for o in ops if o not in _TRIVIAL_OPS | {"while"})

    entry = comps.get("ENTRY", [])
    bodies = [re.search(r"body=%?([\w.\-]+)", ln).group(1)
              for ln in entry if " while(" in ln]
    return {"kernels": count(entry),
            "loop_body_kernels": [count(comps.get(b, [])) for b in bodies]}


def kernels_during_exchange(fn, *args):
    """Kernels the entry computation of ``fn`` runs between its first
    ``collective-permute-start`` and its last ``collective-permute-done``:
    the work XLA's schedule overlaps with the halo exchange (an empty list:
    the exchange is waited for before any compute)."""
    import re

    op_re = re.compile(_OP_RE)
    entry = hlo_computations(fn, *args).get("ENTRY", [])
    ops = [(m.group(1), ln.split("=")[0].strip()) for ln, m in
           ((ln, op_re.search(ln)) for ln in entry) if m]
    kinds = [k for k, _ in ops]
    starts = [i for i, k in enumerate(kinds) if k == "collective-permute-start"]
    dones = [i for i, k in enumerate(kinds) if k == "collective-permute-done"]
    if not starts or not dones:
        return None
    return [name for k, name in ops[starts[0] + 1: dones[-1]]
            if k not in _TRIVIAL_OPS and not k.startswith("collective-permute")]


def rel_err(y, ref):
    y = np.asarray(y, np.float64)
    return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))


def np_stencil(x, sterms, c_grid, stride):
    """float64 numpy application of a strided stencil (the reference for
    cuda_mat.ops.stencil.stencil_matvec)."""
    w = max(abs(o) for o, _ in sterms)
    xe = np.pad(np.asarray(x, np.float64), (w, w))
    y = np.zeros(x.shape[0])
    for off, scal in sterms:
        y += scal * xe[w + off: w + off + x.shape[0]]
    y = y.reshape(-1, stride)
    y[:, c_grid:] = 0.0
    return y.reshape(-1)


def scipy_csr(m):
    import scipy.sparse as sp

    return sp.csr_matrix((np.asarray(m.data, np.float64), m.indices,
                          m.indptr), shape=(m.n, m.m))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_operators(sm, ctx):
    import jax
    import jax.numpy as jnp

    from cuda_mat.models.problems import (grid_laplacian,
                                          random_diag_nonzero_system)
    from cuda_mat.ops.operators import DIAOperator, make_operator
    from cuda_mat.ops.stencil import ConstStencilOperator, series_gap
    from cuda_mat.precond.preconditioners import (ILU0Preconditioner,
                                                  NeumannILUPreconditioner,
                                                  _factorize,
                                                  neumann_factors)
    from cuda_mat.solvers.bicgstab import host_matvec_f64
    from cuda_mat.io.mmio import load_mm_sparse_matrix

    ph = "phase1"
    f32 = jnp.float32
    rng = np.random.default_rng(SEED)

    def put(v):
        return jax.device_put(jnp.asarray(v))

    src = jnp.ones((COPY_ELEMS,), f32)
    t = chain_time(lambda y: y * 1.0000001 + 1.0, src, k=10)
    copy_bw = 2 * COPY_ELEMS * 4 / t
    del src
    sm.report(ph, "copy", bytes_per_direction=COPY_ELEMS * 4,
              l2_bytes=L2_BYTES, ratio_to_l2=COPY_ELEMS * 4 / L2_BYTES,
              t_s=t, gbps=copy_bw / 1e9)
    ctx["copy_bw"] = copy_bw

    def timing(name, step, x, nbytes, scale, args=(), k=20):
        # operators ride as jit arguments, not as captured constants;
        # nbytes is the compulsory traffic of one application (every operand
        # read once, the result written once)
        t = chain_time(lambda y, *a: step(y, *a) * scale, x, k=k, args=args)
        sm.report(ph, name + "_time", t_s=t, bytes_model=nbytes,
                  gbps=nbytes / t / 1e9, copy_share=nbytes / t / copy_bw,
                  **hlo_kernels(step, x, *args))

    # ---- the 10M-row grid: DIA and stencil matvecs -----------------------
    a = grid_laplacian(*FLAGSHIP_GRID)
    ctx["flagship"] = a
    n = a.n
    x = rng.standard_normal(n).astype(np.float32)
    x64 = x.astype(np.float64)
    ref = host_matvec_f64(a, x64)
    absa = type(a)(a.n, a.m, np.abs(a.data), a.indices, a.indptr)
    bound = float(host_matvec_f64(absa, np.abs(x64)).max())
    dia = a.to_dia(max_diags=16)
    op = DIAOperator(jnp.asarray(dia.data, f32),
                     tuple(int(o) for o in dia.offsets), n)
    y = jax.jit(lambda o, v: o.matvec(v))(op, put(x))
    err = float(np.abs(np.asarray(y, np.float64) - ref).max()) / bound
    sm.report(ph, "dia_matvec_f32", n=n, err=err, tol=TOL_MATVEC_F32)
    sm.check(err <= TOL_MATVEC_F32, f"DIA matvec error {err}")
    timing("dia_matvec_f32", lambda v, o: o.matvec(v), put(x),
           (dia.ndiag + 2) * n * 4, 0.1, args=(op,))
    del op, dia

    sop = ConstStencilOperator.from_dia(a.to_dia(max_diags=16), dtype=f32)
    xs = sop.pad_vec(x)
    y = sop.unpad_vec(jax.jit(lambda v: sop.matvec(v))(xs))
    err = float(np.abs(np.asarray(y, np.float64) - ref).max()) / bound
    sm.report(ph, "stencil_matvec_f32", n=n, stride=sop.stride, err=err,
              tol=TOL_MATVEC_F32)
    sm.check(err <= TOL_MATVEC_F32, f"stencil matvec error {err}")
    timing("stencil_matvec_f32", lambda v: sop.matvec(v), xs,
           2 * sop.np_true * 4, 0.1)

    # ---- Neumann msolve (k=4), const-factor and exact-factor ---------------
    k = 4
    sop4 = sop.with_gap(series_gap(sop.terms, k))
    low, up, diag = neumann_factors(a)
    f = rng.standard_normal(n)
    fs = sop4.pad_vec(f.astype(np.float32))
    fs64 = np.asarray(fs, np.float64)
    g = np.zeros((sop4.r, sop4.stride))
    g[:, : sop4.c_grid] = (1.0 / diag).reshape(sop4.r, sop4.c_grid)
    inv_d64 = g.reshape(-1)
    pre = NeumannILUPreconditioner.from_csr(a, dtype=f32, terms=k,
                                            pad_like=sop4)
    sm.check(pre.fused, "const-factor series did not fuse")
    y = jax.jit(lambda p, v: p.msolve(v))(pre, fs)
    ref_m = np_stencil(inv_d64 * np_stencil(fs64, pre.nl.strided_terms,
                                            sop4.c_grid, sop4.stride),
                       pre.nu.strided_terms, sop4.c_grid, sop4.stride)
    err = rel_err(y, ref_m)
    sm.report(ph, "neumann_const_msolve_f32", n=n, terms=k,
              nterms_l=len(pre.nl.terms), nterms_u=len(pre.nu.terms),
              err=err, tol=TOL_MSOLVE_F32)
    sm.check(err <= TOL_MSOLVE_F32, f"const-factor msolve error {err}")
    sc = chain_scale(lambda v: pre.msolve(v), fs)
    timing("neumann_const_msolve_f32", lambda v, p: p.msolve(v), fs,
           3 * sop4.np_true * 4, sc, args=(pre,))

    pre_e = NeumannILUPreconditioner.from_csr(a, dtype=f32, terms=k,
                                              pad_like=sop4,
                                              const_factors=False)
    y = sop4.unpad_vec(jax.jit(lambda p, v: p.msolve(v))(pre_e, fs))
    lo, uo = scipy_csr(low), scipy_csr(up)
    fv = np.asarray(sop4.unpad_vec(fs), np.float64)
    yy, term = fv.copy(), fv.copy()
    for _ in range(k - 1):
        term = -(lo @ term)
        yy = yy + term
    gg = yy / diag
    xx, term = gg.copy(), gg.copy()
    for _ in range(k - 1):
        term = -(uo @ term)
        xx = xx + term
    err = rel_err(y, xx)
    sm.report(ph, "neumann_exact_msolve_f32", n=n, terms=k, err=err,
              tol=TOL_MSOLVE_F32)
    sm.check(err <= TOL_MSOLVE_F32, f"exact-factor msolve error {err}")
    nd = pre_e.nl.data.shape[0] + pre_e.nu.data.shape[0]
    timing("neumann_exact_msolve_f32", lambda v, p: p.msolve(v), fs,
           (nd + 3) * sop4.np_true * 4,
           chain_scale(lambda v: pre_e.msolve(v), fs), args=(pre_e,))
    del pre, pre_e, lo, uo, low, up

    # ---- blocked triangular solve on mat10000's ILU(0) factors ------------
    from scipy.sparse.linalg import spsolve_triangular
    import scipy.sparse as sp

    m10 = load_mm_sparse_matrix(os.path.join(HERE, "data", "mat10000.mtx"))
    mv = _factorize(m10)
    full = sp.csr_matrix((mv, m10.indices, m10.indptr), shape=(m10.n,) * 2)
    lmat = sp.tril(full, -1, format="csr") + sp.identity(m10.n, format="csr")
    umat = sp.triu(full, 0, format="csr")
    f = rng.standard_normal(m10.n)
    x_ref = spsolve_triangular(umat, spsolve_triangular(lmat, f, lower=True),
                               lower=False)
    for dt, tol in ((jnp.float32, TOL_TRI_F32), (jnp.float64, TOL_TRI_F64)):
        tri = ILU0Preconditioner.from_csr(m10, block=128, dtype=dt).tri
        fd = jnp.asarray(f, dt)
        y = jax.jit(lambda t_, v: t_.msolve(v))(tri, fd)
        err = rel_err(y, x_ref)
        name = f"trisolve_{np.dtype(dt).name}"
        sm.report(ph, name, n=m10.n, block=128, nb=tri.nb, err=err, tol=tol)
        sm.check(err <= tol, f"{name} error {err}")
        wbytes = sum(int(np.prod(w.shape)) * w.dtype.itemsize for w in
                     (tri.w_lo, tri.w_up, tri.vals_lo, tri.vals_up,
                      tri.cols_lo, tri.cols_up))
        timing(name, lambda v, t_: t_.msolve(v), fd, wbytes,
               chain_scale(lambda v: tri.msolve(v), fd), args=(tri,), k=10)

    # ---- unstructured: dense, BELL, CSR gather vs cuSPARSE ----------------
    ar, _ = random_diag_nonzero_system(10000, 0.99, seed=SEED)
    xr = rng.standard_normal(ar.n)
    ref = host_matvec_f64(ar, xr.astype(np.float32).astype(np.float64))
    xrj = put(xr.astype(np.float32))
    for fmt in ("dense", "bell", "csr"):
        opf = make_operator(ar, dtype=f32, format=fmt)
        y = jax.jit(lambda o, v: o.matvec(v))(opf, xrj)
        err = rel_err(y, ref)
        sm.report(ph, f"{fmt}_matvec_f32", n=ar.n, nnz=ar.nnz, err=err,
                  tol=TOL_DENSE_F32)
        sm.check(err <= TOL_DENSE_F32, f"{fmt} matvec error {err}")
        nbytes = {"dense": ar.n * ar.n * 4,
                  "bell": int(np.prod(opf.values.shape)) * 4
                  if fmt == "bell" else 0,
                  "csr": ar.nnz * 12}[fmt] + 2 * ar.n * 4
        timing(f"{fmt}_matvec_f32", lambda v, o: o.matvec(v), xrj,
               nbytes, 1e-3, args=(opf,))
        del opf
    from jax.experimental import sparse as jsparse

    jax.config.update("jax_bcoo_cusparse_lowering", True)
    try:
        bm = jsparse.BCSR((jnp.asarray(ar.data, f32),
                           jnp.asarray(ar.indices), jnp.asarray(ar.indptr)),
                          shape=(ar.n, ar.n))
        y = jax.jit(lambda m_, v: m_ @ v)(bm, xrj)
        err = rel_err(y, ref)
        sm.report(ph, "cusparse_csr_matvec_f32", n=ar.n, err=err,
                  tol=TOL_DENSE_F32)
        sm.check(err <= TOL_DENSE_F32, f"cuSPARSE matvec error {err}")
        timing("cusparse_csr_matvec_f32", lambda v, m_: m_ @ v, xrj,
               ar.nnz * 8 + (ar.n + 1) * 4 + 2 * ar.n * 4, 1e-3,
               args=(bm,))
    finally:
        jax.config.update("jax_bcoo_cusparse_lowering", False)


def phase_reference(sm, ctx):
    from cuda_mat import SolverConfig, bicgstab_lu_precond
    from cuda_mat.cli import main as cli_main
    from cuda_mat.io.mmio import load_mm_sparse_matrix

    ph = "phase2"
    for name in ("mat10000", "mat900"):
        a = load_mm_sparse_matrix(os.path.join(HERE, "data", name + ".mtx"))
        golden = int(np.load(os.path.join(
            HERE, "tests", "goldens", name + "_ilu.npz"))["iters"])
        r = bicgstab_lu_precond(a, np.ones(a.n),
                                SolverConfig(tol=1e-6, maxit=2000))
        rel = r.residual_true / r.residual0
        sm.report(ph, name + "_ilu_f64", iters=r.iters, golden=golden,
                  status=r.status.name, true_rel_residual=rel,
                  tol=TOL_TRUE_RES, dt_alg_s=r.dt_alg, dt_setup_s=r.dt_setup)
        sm.check(r.converged, f"{name} did not converge: {r.status}")
        sm.check(abs(r.iters - golden) <= 1,
              f"{name}: {r.iters} iterations, golden {golden}")
        sm.check(rel <= TOL_TRUE_RES, f"{name} true residual {rel}")
    rc = cli_main(["-M", os.path.join(HERE, "data", "mat10000.mtx"),
                   "--x64", "--precond", "ilu0"])
    sm.report(ph, "cli_mat10000", rc=rc)
    sm.check(rc == 0, f"CLI returned {rc}")


def phase_flagship(sm, ctx):
    from cuda_mat import SolverConfig, make_solver, solve_refined
    from cuda_mat.models.problems import grid_laplacian
    from cuda_mat.solvers.bicgstab import host_matvec_f64

    ph = "phase3"
    a = ctx.get("flagship")
    if a is None:
        a = grid_laplacian(*FLAGSHIP_GRID)
    b = np.ones(a.n)
    r0 = float(np.linalg.norm(b - host_matvec_f64(a, np.ones(a.n))))
    cfg = SolverConfig(dtype="float32", precond="ilu0_neumann",
                       neumann_terms=4, tol=1e-4)
    for label, c in (("ilu0", cfg), ("milu096", cfg.replace(milu_omega=0.96))):
        ps = make_solver(a, c)
        cold = ps.solve(b)
        warm = sorted((ps.solve(b) for _ in range(3)), key=lambda r: r.dt_alg)
        med = warm[1]
        sm.report(ph, f"flagship_{label}", n=a.n, iters=med.iters,
                  status=med.status.name, dt_setup_s=ps.dt_setup,
                  dt_alg_cold_s=cold.dt_alg, dt_alg_median_s=med.dt_alg,
                  dt_alg_warm_s=[r.dt_alg for r in warm],
                  ms_per_iter=med.dt_alg / max(med.iters, 1) * 1e3)
        sm.check(med.converged, f"flagship {label}: {med.status}")
        if label == "ilu0":
            import jax.numpy as jnp

            from cuda_mat.solvers.bicgstab import _precond_solve

            bd = ps._prep_vec(b)
            tol = jnp.asarray(1e-4, jnp.float32)
            sm.report(ph, "flagship_loop_hlo", **hlo_kernels(
                lambda pre, v: _precond_solve(ps.op, pre, v, v, tol, 2000,
                                              False, True), ps.pre, bd))
        rr = solve_refined(a, b, c.replace(tol=1e-6), inner_tol=1e-4,
                           solver=ps)
        rel = float(np.linalg.norm(b - host_matvec_f64(a, rr.x))) / r0
        sm.report(ph, f"flagship_{label}_refined", restarts=len(
                  rr.residual_history) - 1, inner_iters=rr.iters,
                  dt_alg_s=rr.dt_alg, true_rel_residual=rel,
                  tol=TOL_TRUE_RES)
        sm.check(rr.converged and rel <= TOL_TRUE_RES,
              f"flagship {label} refined: {rr.status} {rel}")


def _compare(sm, ph, name, rd, rs, iters_band):
    dx = rel_err(rd.x, np.asarray(rs.x, np.float64))
    sm.report(ph, name, status=rd.status.name, iters=rd.iters,
              iters_single=rs.iters, iters_band=iters_band, dx=dx,
              tol=TOL_X_DIST, dt_alg_s=rd.dt_alg, dt_alg_single_s=rs.dt_alg,
              dt_setup_s=rd.dt_setup,
              ms_per_iter=rd.dt_alg / max(rd.iters, 1) * 1e3,
              ms_per_iter_single=rs.dt_alg / max(rs.iters, 1) * 1e3)
    sm.check(rd.converged and rs.converged, f"{name}: not converged")
    sm.check(iters_band[0] <= rd.iters - rs.iters <= iters_band[1],
          f"{name}: {rd.iters} vs {rs.iters} iterations")
    sm.check(dx <= TOL_X_DIST, f"{name}: x differs by {dx}")


def phase_dist1(sm, ctx):
    from cuda_mat import SolverConfig, make_solver
    from cuda_mat.models.problems import grid_laplacian
    from cuda_mat.parallel.dist_solver import make_dist_bicgstab
    from cuda_mat.parallel.mesh import make_mesh

    a = grid_laplacian(*ONE_M_GRID)
    b = np.ones(a.n)
    cfg = SolverConfig(dtype="float32", precond="ilu0_neumann",
                       neumann_terms=3, tol=1e-4)
    ds = make_dist_bicgstab(a, make_mesh(1), cfg)
    ds.solve(b)
    rd = ds.solve(b)
    ps = make_solver(a, cfg)
    ps.solve(b)
    rs = ps.solve(b)
    # the dots run over the partition-padded vector, so their f32 sums are
    # ordered differently; the residual sits at ~1.07e-4 for its last few
    # iterations before it crosses the 1e-4 tolerance, so that rounding
    # decides between stopping points ~6 iterations apart
    band = max(3, rs.iters // 5)
    _compare(sm, "phase4", "dist_mesh1_1m_ilu0_neumann", rd, rs,
             (-band, band))


def phase_multi(sm, ctx):
    import jax

    from cuda_mat import SolverConfig, make_solver, solve_refined
    from cuda_mat.models.problems import grid_laplacian
    from cuda_mat.parallel.dist_solver import (make_dist_bicgstab,
                                               make_dist_spmv)
    from cuda_mat.parallel.mesh import make_mesh
    from cuda_mat.parallel.partition import RowPartitionedStencil
    from cuda_mat.solvers.bicgstab import host_matvec_f64

    ph = "phase5"
    if len(jax.devices()) < 4:
        raise PhaseFailure(f"--multi needs 4 GPUs, found {len(jax.devices())}")
    mesh = make_mesh(4)
    a = grid_laplacian(*FLAGSHIP_GRID)
    b = np.ones(a.n)

    # where the shards live: the distributed stencil SpMV on the 10M grid
    part = RowPartitionedStencil.from_matrix(a, 4)
    fn, put = make_dist_spmv(part, mesh, dtype=np.float32,
                             local_engine="stencil")
    x = np.random.default_rng(SEED).standard_normal(a.n)
    y = fn(put(x))
    y.block_until_ready()
    shards = sorted((s.device.id, s.data.shape[0]) for s in
                    y.addressable_shards)
    mem = [(d.memory_stats() or {}).get("bytes_in_use", -1)
           for d in mesh.devices]
    print(f"x.sharding.device_set = {sorted(d.id for d in y.sharding.device_set)}"
          f"; shards (device, rows) = {shards}; bytes_in_use per card = {mem}",
          flush=True)
    err = rel_err(part.unpad_vector(np.asarray(y)),
                  host_matvec_f64(a, x.astype(np.float32).astype(np.float64)))
    sm.report(ph, "dist_spmv_10m_mesh4", err=err, tol=TOL_MSOLVE_F32,
              devices=len(y.sharding.device_set), bytes_in_use=mem)
    sm.check(len({d for d, _ in shards}) == 4,
             f"shards not on 4 cards: {shards}")
    sm.check(err <= TOL_MSOLVE_F32, f"distributed SpMV error {err}")

    # its time per application, and what XLA schedules during its halo
    # exchange (the local work alone is ~1/4 of the one-card stencil)
    xs = put(x)
    sm.report(ph, "dist_spmv_10m_mesh4_time",
              t_s=chain_time(lambda v: fn(v) * 0.1, xs),
              kernels_during_exchange=kernels_during_exchange(fn, xs))

    cfg = SolverConfig(dtype="float32", neumann_terms=4, tol=1e-4)
    for precond in ("jacobi", "ilu0_neumann"):
        c = cfg.replace(precond=precond)
        ds = make_dist_bicgstab(a, mesh, c)
        ds.solve(b)
        rd = ds.solve(b)
        ps = make_solver(a, c)
        ps.solve(b)
        rs = ps.solve(b)
        # same algorithm; only the order of the f32 dot-product sums differs
        # (a psum of 4 partials), which BiCGSTAB amplifies into a different
        # iteration count, the more so the more iterations it runs
        band = max(3, rs.iters // 5)
        _compare(sm, ph, f"dist_mesh4_10m_{precond}", rd, rs, (-band, band))
        del ds
        # the XLA banded engine (DIA data with halo exchange; exact-pattern
        # Neumann factors) on the same mesh: what "auto" chose on a GPU
        # before the stencil engine ran there, timed beside it
        dx_ = make_dist_bicgstab(a, mesh, c, local_engine="xla")
        dx_.solve(b)
        rx = dx_.solve(b)
        sm.report(ph, f"dist_mesh4_10m_{precond}_xla_engine",
                  status=rx.status.name, iters=rx.iters,
                  dt_alg_s=rx.dt_alg, dt_setup_s=rx.dt_setup,
                  ms_per_iter=rx.dt_alg / max(rx.iters, 1) * 1e3,
                  dx_single=rel_err(rx.x, np.asarray(rs.x, np.float64)))
        sm.check(rx.converged, f"xla engine {precond}: {rx.status}")
        del dx_, ps
    r0 = float(np.linalg.norm(b - host_matvec_f64(a, np.ones(a.n))))
    rr = solve_refined(a, b, cfg.replace(precond="ilu0_neumann", tol=1e-6),
                       inner_tol=1e-4, mesh=mesh)
    rel = float(np.linalg.norm(b - host_matvec_f64(a, rr.x))) / r0
    sm.report(ph, "dist_mesh4_10m_refined", inner_iters=rr.iters,
              dt_alg_s=rr.dt_alg, true_rel_residual=rel, tol=TOL_TRUE_RES)
    sm.check(rr.converged and rel <= TOL_TRUE_RES, f"refined: {rel}")

    # block-Jacobi ILU(0), the distributed form of the reference's exact
    # ILU(0) path, in that path's float64 (in float32 its residual stalls at
    # ~1.1e-4, right at the tolerance).  4 shards drop the off-shard
    # couplings of the global ILU(0) that the one-shard solve keeps, so they
    # may need more iterations, never fewer by more than rounding.  One
    # (cold) solve each: the sweeps are launch-bound, seconds per solve.
    a1 = grid_laplacian(*ONE_M_GRID)
    b1 = np.ones(a1.n)
    c = SolverConfig(dtype="float64", precond="bjacobi_ilu0", tol=1e-4,
                     trisolve_block=128)
    rs = make_dist_bicgstab(a1, make_mesh(1), c).solve(b1)
    rd = make_dist_bicgstab(a1, mesh, c).solve(b1)
    _compare(sm, ph, "dist_mesh4_1m_bjacobi_ilu0_f64", rd, rs,
             (-2, max(10, rs.iters)))
    # the same on 4 cards in float32, where the residual stalls at the
    # tolerance: a NaN must surface as BREAKDOWN, never as a non-finite x
    # under another status; a converged x must be the float64 answer.
    # maxit bounds the launch-bound sweeps (~0.15 s per iteration)
    r32 = make_dist_bicgstab(a1, mesh, c.replace(
        dtype="float32", maxit=300)).solve(b1)
    finite = bool(np.isfinite(r32.x).all())
    sm.report(ph, "dist_mesh4_1m_bjacobi_ilu0_f32", status=r32.status.name,
              iters=r32.iters, x_finite=finite,
              rel_residual=r32.residual / r32.residual0,
              dx_f64_single=rel_err(r32.x, np.asarray(rs.x, np.float64))
              if finite else float("nan"),
              dt_alg_s=r32.dt_alg, dt_setup_s=r32.dt_setup)
    sm.check(finite or r32.status.name == "BREAKDOWN",
             f"bjacobi f32: non-finite x under status {r32.status.name}")
    if r32.status.name == "CONVERGED":
        sm.check(finite and rel_err(r32.x, np.asarray(rs.x, np.float64))
                 <= TOL_X_DIST, "bjacobi f32 converged to another x")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the 4-GPU distributed phase")
    p.add_argument("--out", help="write all records to this JSON file")
    args = p.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX runs on "
              f"{jax.default_backend()}", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, HERE)
    from cuda_mat.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    cards = card_lines()
    for ln in cards:
        print(f"card: {ln}", flush=True)
    sm = Smoke(cards[0])

    mk = subprocess.run(["make", "-C", os.path.join(HERE, "cuda_mat",
                                                    "native")],
                        capture_output=True, text=True, timeout=600)
    from cuda_mat.native import loader

    print(f"native library: make rc={mk.returncode}, "
          f"loaded={loader.available()}", flush=True)
    if mk.returncode != 0 or not loader.available():
        print(mk.stdout[-2000:] + mk.stderr[-2000:], file=sys.stderr)
        return 1

    phases = ([("phase5_multi", phase_multi)] if args.multi else
              [("phase1_operators", phase_operators),
               ("phase2_reference", phase_reference),
               ("phase3_flagship", phase_flagship),
               ("phase4_dist_mesh1", phase_dist1)])
    ctx = {}
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        try:
            fn(sm, ctx)
            sm.end_phase()
        except Exception:                       # report, run the rest, fail
            traceback.print_exc()
            sm.failures = []
            failed.append(name)
        print(f"== {name} {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"cards": cards, "failed": failed,
                       "records": sm.records}, fh, indent=1, default=str)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
