"""Platform plumbing: the one operator/engine selection point, full-precision
products on the solve path, the compile-cache placement, and the refusal of
the on-card smoke test to run anywhere but a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_mat.config import SolverConfig
from cuda_mat.models.problems import (banded_laplacian, gen_rand_csr_matrix,
                                      grid_laplacian, laplacian_2d)
from cuda_mat.ops.selection import check_platform, select_format

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _banded_nonconst():
    a = banded_laplacian(12)
    a.data[::7] *= 1.5            # breaks the constant-coefficient proof
    return a


def _long_rows():
    # one dense row: ELL would pad every row to n entries
    from cuda_mat.formats.coo import COOMatrix
    from cuda_mat.formats.csr import CSRMatrix

    n = 200
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.zeros(n, np.int64), np.arange(n),
                           rng.integers(0, n, 3 * n)])
    cols = np.concatenate([np.arange(n), np.arange(n),
                           rng.integers(0, n, 3 * n)])
    return CSRMatrix.from_coo(COOMatrix(n, n, rows, cols, np.ones(rows.size)),
                              sum_duplicates=True)


KINDS = {
    "stencil5": (lambda: grid_laplacian(20, 30), "stencil"),
    "stencil9": (lambda: laplacian_2d(15), "stencil"),
    "banded": (_banded_nonconst, "dia"),
    "short_rows": (lambda: gen_rand_csr_matrix(300, 300, 0.99, 0.5, 2.0,
                                               seed=3), "ell"),
    "long_rows": (_long_rows, "csr"),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_select_format_by_kind(kind):
    """The structure-driven choice, one matrix kind per case."""
    make, want = KINDS[kind]
    fmt, dia = select_format(make())
    assert fmt == want
    assert (dia is not None) == (want in ("stencil", "dia"))


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_check_platform_accepts_supported(platform, monkeypatch):
    assert check_platform(platform) == platform
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert check_platform() == platform


@pytest.mark.parametrize("platform", ["rocm", "metal", "interpreter"])
def test_check_platform_refuses_unknown(platform):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        check_platform(platform)


@pytest.mark.parametrize("entry", ["make_solver", "make_operator",
                                   "make_dist_bicgstab", "cli"])
def test_entry_points_refuse_unknown_platform(entry, monkeypatch):
    """Each entry point that builds a device operator refuses a platform
    this program was not written for, before any work."""
    from cuda_mat.cli import main
    from cuda_mat.ops.operators import make_operator
    from cuda_mat.parallel.dist_solver import make_dist_bicgstab
    from cuda_mat.parallel.mesh import make_mesh
    from cuda_mat.solvers.bicgstab import make_solver

    a = grid_laplacian(20, 30)
    mesh = make_mesh(1)
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    call = {
        "make_solver": lambda: make_solver(a, SolverConfig()),
        "make_operator": lambda: make_operator(a),
        "make_dist_bicgstab": lambda: make_dist_bicgstab(a, mesh),
        "cli": lambda: main(["-M", os.path.join(REPO, "data",
                                                "mat900.mtx")]),
    }[entry]
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        call()


# ---------------------------------------------------------------------------
# full-precision products: no dot_general at DEFAULT precision in f32 loops
# ---------------------------------------------------------------------------


def _dot_precisions(jaxpr):
    """(precision of every dot_general eqn, recursively)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    out += _dot_precisions(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
    return out


def _assert_highest(closed):
    precs = _dot_precisions(closed.jaxpr)
    assert precs, "no dot_general found"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(q == hi for q in p), p


def _solver_jaxpr(a, cfg, fmt=None):
    from cuda_mat.solvers.bicgstab import (_hform_solve, _precond_solve,
                                           make_solver)

    ps = make_solver(a, cfg, format=fmt)
    b = ps._prep_vec(np.ones(a.n))
    tol = jnp.asarray(1e-4, jnp.float32)
    if ps.pre is None:
        return jax.make_jaxpr(_hform_solve, static_argnums=(5, 6))(
            ps.op, b, b, tol, tol, 20, False)
    return jax.make_jaxpr(_precond_solve, static_argnums=(5, 6, 7))(
        ps.op, ps.pre, b, b, tol, 20, False, True)


@pytest.mark.parametrize("loop", ["hform", "ilu0_trisolve", "neumann_stencil",
                                  "dense_jacobi", "bicg", "distributed"])
def test_f32_solve_loops_use_highest_precision(loop):
    """Every dot_general of an f32 solve loop asks for HIGHEST precision, so
    no product on the solve path may run in TF32 on the GPU."""
    f32 = dict(dtype="float32", maxit=20)
    a = laplacian_2d(12)
    if loop == "hform":
        closed = _solver_jaxpr(a, SolverConfig(precond="none", **f32))
    elif loop == "ilu0_trisolve":
        closed = _solver_jaxpr(a, SolverConfig(precond="ilu0",
                                               trisolve_block=32, **f32))
    elif loop == "neumann_stencil":
        closed = _solver_jaxpr(a, SolverConfig(precond="ilu0_neumann", **f32))
    elif loop == "dense_jacobi":
        closed = _solver_jaxpr(a, SolverConfig(precond="jacobi", **f32),
                               fmt="dense")
    elif loop == "bicg":
        from cuda_mat.ops.operators import make_operator
        from cuda_mat.solvers.bicg import _bicg_solve

        op = make_operator(a, dtype=jnp.float32, format="dense")
        b = jnp.ones(a.n, jnp.float32)
        closed = jax.make_jaxpr(_bicg_solve, static_argnums=(4, 5))(
            op, op, b, jnp.float32(1e-4), 20, False)
    else:
        from cuda_mat.parallel.dist_solver import make_dist_bicgstab
        from cuda_mat.parallel.mesh import make_mesh

        ds = make_dist_bicgstab(a, make_mesh(2), SolverConfig(
            precond="ilu0_neumann", **f32))
        b = ds._put_vec(np.ones(a.n))
        closed = jax.make_jaxpr(ds._run)(
            *ds._mat_args, b, b, ds._inv_diag, ds._tol, ds._btol,
            *ds._tri_stacked, *ds._fac_args)
    _assert_highest(closed)


# ---------------------------------------------------------------------------
# compile cache placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, tmp_path, monkeypatch):
    from cuda_mat.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself: nothing else is set here
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            ignored = subprocess.run(
                ["git", "check-ignore", "-q", path], cwd=REPO)
            assert ignored.returncode == 0, ".jax_cache is not git-ignored"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ---------------------------------------------------------------------------
# chip_smoke.py refuses to run without a GPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """On the CPU backend (and in a directory without the package) the
    smoke test exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, env=env, cwd=os.path.dirname(script),
                       timeout=240)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


# ---------------------------------------------------------------------------
# on the card only
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_trisolve_f32_is_full_precision_on_gpu(gpu, mat10000):
    """The f32 blocked triangular solve agrees with scipy's f64 solve to
    f32 rounding: a TF32 product would leave ~1e-3."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    from cuda_mat.precond.preconditioners import (ILU0Preconditioner,
                                                  _factorize)

    mv = _factorize(mat10000)
    full = sp.csr_matrix((mv, mat10000.indices, mat10000.indptr),
                         shape=(mat10000.n,) * 2)
    lo = sp.tril(full, -1, format="csr") + sp.identity(mat10000.n,
                                                        format="csr")
    up = sp.triu(full, 0, format="csr")
    f = np.random.default_rng(0).standard_normal(mat10000.n)
    ref = spsolve_triangular(up, spsolve_triangular(lo, f, lower=True),
                             lower=False)
    tri = ILU0Preconditioner.from_csr(mat10000, block=128,
                                      dtype=jnp.float32).tri
    y = np.asarray(tri.msolve(jnp.asarray(f, jnp.float32)), np.float64)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 2e-5


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_cli_names_platform_and_refuses_a_missing_one(platform, capsys):
    """The CLI prints the platform and device it ran on; asked for a
    platform JAX does not run on, it fails instead of running elsewhere."""
    from cuda_mat.cli import main

    before = jax.config.jax_platforms
    try:
        rc = main(["-M", os.path.join(REPO, "data", "mat900.mtx"), "--x64",
                   "--platform", platform])
    finally:
        jax.config.update("jax_platforms", before)
    out = capsys.readouterr()
    if platform == "cpu":
        assert rc == 0
        assert "platform=cpu, device=cpu" in out.out
    else:
        assert rc == 1
        assert "requested" in out.err and "iterations" not in out.out
