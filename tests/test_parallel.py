"""Distributed-layer tests on the forced 8-device CPU host platform
(SURVEY §4 implication 4): row-partitioned SpMV + halo exchange + psum dots
must match the single-chip results exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_mat.config import SolverConfig
from cuda_mat.models.problems import banded_laplacian
from cuda_mat.parallel.mesh import make_mesh
from cuda_mat.parallel.partition import RowPartitionedBanded
from cuda_mat.parallel.dist_solver import (dist_bicgstab, dist_spmv,
                                               make_dist_spmv)
from cuda_mat.reference.cpu_solvers import bicgstab_hform_cpu
from cuda_mat.solvers.bicgstab import bicgstab


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def lap():
    return banded_laplacian(40)  # n=1600, w=40


def test_partition_plan(lap):
    part = RowPartitionedBanded.from_matrix(lap, 8)
    assert part.npad == 1600 and part.shard_rows == 200 and part.halo == 40
    # padded rows are identity
    part2 = RowPartitionedBanded.from_matrix(banded_laplacian(13), 8)  # n=169
    assert part2.npad == 176
    k0 = part2.offsets.index(0)
    np.testing.assert_allclose(part2.data[k0, 169:], 1.0)


def test_partition_rejects_wide_band():
    with pytest.raises(ValueError):
        RowPartitionedBanded.from_matrix(banded_laplacian(4), 8)  # n=16, w=4>2


@needs_8
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_dist_spmv_matches_host(lap, ndev, rng):
    mesh = make_mesh(ndev)
    x = rng.standard_normal(lap.n)
    y = dist_spmv(lap, x, mesh)
    np.testing.assert_allclose(y, lap.matvec(x), rtol=1e-12, atol=1e-12)


@needs_8
def test_dist_spmv_uneven_rows(rng):
    a = banded_laplacian(13)  # n=169, not divisible by 8
    mesh = make_mesh(8)
    x = rng.standard_normal(a.n)
    y = dist_spmv(a, x, mesh)
    np.testing.assert_allclose(y, a.matvec(x), rtol=1e-12, atol=1e-12)


@needs_8
def test_dist_bicgstab_matches_oracle(lap, rng):
    b = rng.uniform(1.0, 5.0, lap.n)
    mesh = make_mesh(8)
    cfg = SolverConfig(maxit=2000, tol=1e-6)
    res = dist_bicgstab(lap, b, mesh, cfg)
    ref = bicgstab_hform_cpu(lap, b, maxit=2000, tol=1e-6)
    assert res.converged
    assert abs(res.iters - ref.iters) <= 5
    np.testing.assert_allclose(res.trajectory()[:10],
                               np.asarray(ref.residual_history)[:10],
                               rtol=1e-6, atol=1e-9)
    r = np.linalg.norm(b - lap.matvec(res.x)) / np.linalg.norm(b)
    assert r < 1e-5


@needs_8
def test_dist_bicgstab_matches_single_chip(lap, rng):
    """Distributed vs single-device solve of the identical algorithm."""
    b = rng.uniform(1.0, 5.0, lap.n)
    cfg = SolverConfig(maxit=2000, tol=1e-6)
    res_d = dist_bicgstab(lap, b, make_mesh(4), cfg)
    res_s = bicgstab(lap, b, cfg)
    assert res_d.converged and res_s.converged
    np.testing.assert_allclose(res_d.x, res_s.x, rtol=1e-6, atol=1e-8)


@needs_8
def test_dist_jacobi(lap, rng):
    b = rng.uniform(1.0, 5.0, lap.n)
    cfg = SolverConfig(maxit=2000, tol=1e-6, precond="jacobi")
    res = dist_bicgstab(lap, b, make_mesh(8), cfg)
    assert res.converged
    r = np.linalg.norm(b - lap.matvec(res.x)) / np.linalg.norm(b)
    assert r < 1e-5


@needs_8
def test_dist_single_device_mesh(lap, rng):
    """ndev=1 degenerates to a local solve (no ppermute partners)."""
    b = rng.uniform(1.0, 5.0, lap.n)
    res = dist_bicgstab(lap, b, make_mesh(1), SolverConfig(tol=1e-6))
    assert res.converged


@needs_8
def test_make_dist_spmv_reuse(lap, rng):
    mesh = make_mesh(8)
    part = RowPartitionedBanded.from_matrix(lap, 8)
    fn, put = make_dist_spmv(part, mesh, dtype=jnp.float64)
    for _ in range(2):
        x = rng.standard_normal(lap.n)
        y = part.unpad_vector(np.asarray(fn(put(x))))
        np.testing.assert_allclose(y, lap.matvec(x), rtol=1e-12, atol=1e-12)


@needs_8
@pytest.mark.parametrize("ndev", [2, 8])
def test_dist_block_jacobi_ilu(lap, ndev, rng):
    """Block-Jacobi ILU(0): per-shard local ILU solves, no communication in
    the preconditioner application."""
    b = rng.uniform(1.0, 5.0, lap.n)
    cfg = SolverConfig(maxit=2000, tol=1e-6, precond="bjacobi_ilu0",
                       trisolve_block=64)
    res = dist_bicgstab(lap, b, make_mesh(ndev), cfg)
    assert res.converged
    r = np.linalg.norm(b - lap.matvec(res.x)) / np.linalg.norm(b)
    assert r < 1e-5


@needs_8
def test_dist_bjacobi_single_shard_matches_global_ilu(lap, rng):
    """With one shard, block-Jacobi ILU(0) IS global ILU(0): trajectory must
    match the single-chip preconditioned solver."""
    from cuda_mat.solvers.bicgstab import bicgstab_lu_precond

    b = rng.uniform(1.0, 5.0, lap.n)
    cfg = SolverConfig(maxit=2000, tol=1e-6, precond="bjacobi_ilu0",
                       trisolve_block=64)
    res_d = dist_bicgstab(lap, b, make_mesh(1), cfg)
    res_s = bicgstab_lu_precond(lap, b, SolverConfig(maxit=2000, tol=1e-6,
                                                     trisolve_block=64))
    assert res_d.converged and res_s.converged
    assert abs(res_d.iters - res_s.iters) <= 1
    np.testing.assert_allclose(res_d.x, res_s.x, rtol=1e-5, atol=1e-7)


@needs_8
def test_dist_rejects_plain_ilu0(lap):
    with pytest.raises(ValueError):
        dist_bicgstab(lap, np.ones(lap.n), make_mesh(4),
                      SolverConfig(precond="ilu0"))


@needs_8
def test_dist_general_allgather(rng):
    """Non-banded matrix → ELL partition + all-gathered x."""
    from cuda_mat.formats.csr import CSRMatrix
    from cuda_mat.models.problems import gen_rand_csr_matrix

    a0 = gen_rand_csr_matrix(200, 200, 0.9, 0.5, 2.0, seed=17)
    a = CSRMatrix.from_dense(a0.to_dense() + 100 * np.eye(200))
    b = rng.uniform(1.0, 5.0, 200)
    mesh = make_mesh(8)
    res = dist_bicgstab(a, b, mesh, SolverConfig(maxit=2000, tol=1e-8),
                        halo_mode="allgather")
    assert res.converged
    r = np.linalg.norm(b - a.matvec(res.x)) / np.linalg.norm(b)
    assert r < 1e-6
    # jacobi also works in allgather mode
    res_j = dist_bicgstab(a, b, mesh,
                          SolverConfig(maxit=2000, tol=1e-8, precond="jacobi"),
                          halo_mode="allgather")
    assert res_j.converged


@needs_8
def test_dist_auto_falls_back_to_allgather(rng):
    """A matrix with too many diagonals auto-selects the all-gather path."""
    from cuda_mat.formats.csr import CSRMatrix

    rng2 = np.random.default_rng(3)
    d = np.where(rng2.random((120, 120)) > 0.9, rng2.standard_normal((120, 120)),
                 0.0) + 60 * np.eye(120)
    a = CSRMatrix.from_dense(d)
    b = rng.uniform(1.0, 5.0, 120)
    res = dist_bicgstab(a, b, make_mesh(8), SolverConfig(maxit=2000, tol=1e-8))
    assert res.converged


@needs_8
def test_dist_ppermute_mode_rejects_general(rng):
    from cuda_mat.formats.csr import CSRMatrix

    rng2 = np.random.default_rng(4)
    d = np.where(rng2.random((64, 64)) > 0.8, 1.0, 0.0) + 40 * np.eye(64)
    a = CSRMatrix.from_dense(d)
    with pytest.raises(ValueError):
        dist_bicgstab(a, np.ones(64), make_mesh(8), SolverConfig(),
                      halo_mode="ppermute")


@needs_8
def test_overlap_split_matches_unsplit(lap, rng):
    """The interior/boundary split form of the local matvec (overlap=True)
    is bitwise identical to the unsplit form — same per-row operations in the
    same order, just a different dependency graph for the scheduler."""
    from functools import partial as _partial

    from jax.sharding import PartitionSpec as P

    from cuda_mat.parallel.dist_solver import _make_local_matvec

    mesh = make_mesh(4)
    axis = mesh.axis_names[0]
    part = RowPartitionedBanded.from_matrix(lap, 4)
    data = jax.device_put(
        jnp.asarray(part.data),
        jax.sharding.NamedSharding(mesh, P(None, axis)))
    x = jax.device_put(
        jnp.asarray(part.pad_vector(rng.standard_normal(lap.n))),
        jax.sharding.NamedSharding(mesh, P(axis)))
    out = []
    for overlap in (False, True):
        mv = _make_local_matvec(part.offsets, part.halo, part.shard_rows,
                                4, axis, overlap=overlap)
        f = jax.jit(_partial(jax.shard_map, mesh=mesh,
                             in_specs=(P(None, axis), P(axis)),
                             out_specs=P(axis))(mv))
        out.append(np.asarray(f(data, x)))
    np.testing.assert_array_equal(out[0], out[1])


@needs_8
def test_weak_scaling_harness_runs(capsys):
    """benchmarks/weak_scaling.py code path on the virtual mesh (numbers are
    meaningless on shared host cores; this validates mechanics + JSON)."""
    import importlib.util
    import json
    import os

    spec = importlib.util.spec_from_file_location(
        "weak_scaling", os.path.join(os.path.dirname(__file__), "..",
                                     "benchmarks", "weak_scaling.py"))
    ws = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ws)
    ws.main(["--devices", "1", "2", "--rows-per-dev", "4000",
             "--bandwidth", "50", "--iters", "2", "--dtype", "float64"])
    line = [l for l in capsys.readouterr().out.splitlines() if l.strip()][-1]
    out = json.loads(line)
    assert out["metric"] == "weak_scaling_efficiency"
    assert len(out["configs"]) == 2
    # the flagship stencil engine through the same harness
    ws.main(["--devices", "2", "--rows-per-dev", "8064", "--grid-cols", "126",
             "--engine", "stencil", "--iters", "2", "--dtype", "float64"])
    out_s = json.loads([l for l in capsys.readouterr().out.splitlines()
                        if l.strip()][-1])
    assert out_s["configs"][0]["ndev"] == 2


@needs_8
def test_dist_ilu0_neumann(lap, rng):
    """Distributed Neumann-series ILU(0): converges and matches the
    single-chip ilu0_neumann trajectory."""
    from cuda_mat.solvers.bicgstab import solve

    b = rng.uniform(1.0, 5.0, lap.n)
    cfg = SolverConfig(maxit=2000, tol=1e-8, precond="ilu0_neumann",
                       neumann_terms=3)
    res_d = dist_bicgstab(lap, b, make_mesh(8), cfg)
    res_s = solve(lap, b, cfg, format="dia")
    assert res_d.converged and res_s.converged
    assert abs(res_d.iters - res_s.iters) <= 1
    np.testing.assert_allclose(res_d.x, res_s.x, rtol=1e-6, atol=1e-9)
    r = np.linalg.norm(b - lap.matvec(res_d.x)) / np.linalg.norm(b)
    assert r < 1e-6


def test_dist_ilu0_neumann_rejects_general(rng):
    from cuda_mat.models.problems import random_diag_nonzero_system

    a, b = random_diag_nonzero_system(64, prob_of_zero=0.7)
    cfg = SolverConfig(maxit=50, precond="ilu0_neumann")
    with pytest.raises(ValueError, match="banded"):
        dist_bicgstab(a, b, make_mesh(min(4, len(jax.devices()))), cfg)


# ---------------------------------------------------------------------------
# Distributed gap-strided constant-stencil engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid():
    from cuda_mat.models.problems import grid_laplacian

    return grid_laplacian(64, 126)  # n=8064; stride=127, np_true=8128


def test_partition_stencil_plan(grid):
    from cuda_mat.parallel.partition import RowPartitionedStencil

    part = RowPartitionedStencil.from_matrix(grid, 8)
    assert part.stride == 127 and part.np_true == 64 * 127
    assert part.shard_rows % part.stride == 0     # whole grid rows per shard
    assert part.npad == 8 * part.shard_rows
    assert part.halo == part.stride <= part.shard_rows
    # gap cells (and the partition's padding rows) are zero
    wide = RowPartitionedStencil.from_matrix(grid, 3, gap=4)
    assert wide.stride == 130 and wide.npad == 3 * 22 * 130
    g = wide.pad_vector(np.ones(grid.n)).reshape(-1, 130)
    np.testing.assert_array_equal(g[:64, :126], 1.0)
    assert not g[:, 126:].any() and not g[64:].any()
    # round trip through the strided layout
    v = np.arange(part.n, dtype=np.float64)
    np.testing.assert_array_equal(part.unpad_vector(part.pad_vector(v)), v)


def test_partition_stencil_rejects_nonstencil(lap):
    from cuda_mat.parallel.partition import RowPartitionedStencil

    # banded_laplacian(40) is a 1-D band with varying diagonal data pattern
    from cuda_mat.models.problems import random_diag_nonzero_system

    a, _ = random_diag_nonzero_system(64, prob_of_zero=0.7)
    with pytest.raises(ValueError):
        RowPartitionedStencil.from_matrix(a, 4)


@needs_8
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_dist_spmv_stencil_engine(grid, ndev, rng):
    """Distributed gap-strided stencil == host matvec, including the
    ppermute halo hand-off and the padding-row mask."""
    mesh = make_mesh(ndev)
    x = rng.standard_normal(grid.n)
    y = dist_spmv(grid, x, mesh, local_engine="stencil")
    np.testing.assert_allclose(y, grid.matvec(x), rtol=1e-12, atol=1e-12)


@needs_8
def test_dist_spmv_stencil_global_tail(rng):
    """Grid rows not divisible by the shard count: the partition's padding
    rows live in the last shard and must be masked with the shard's global
    row index, not its local one."""
    from cuda_mat.models.problems import grid_laplacian

    a = grid_laplacian(63, 126)  # 63 grid rows over 8 shards of 8 rows
    mesh = make_mesh(8)
    x = rng.standard_normal(a.n)
    y = dist_spmv(a, x, mesh, local_engine="stencil")
    np.testing.assert_allclose(y, a.matvec(x), rtol=1e-12, atol=1e-12)


@needs_8
def test_dist_bicgstab_stencil_matches_single_chip(grid, rng):
    """Distributed stencil-engine solve tracks the single-chip
    ConstStencilOperator solve (same stencil, psum dots reorder
    reductions)."""
    from cuda_mat.solvers.bicgstab import solve

    b = rng.uniform(1.0, 5.0, grid.n)
    cfg = SolverConfig(maxit=1000, tol=1e-8)
    r_d = dist_bicgstab(grid, b, make_mesh(8), cfg, local_engine="stencil")
    r_s = solve(grid, b, cfg, format="stencil")
    assert r_d.converged and r_s.converged
    # ~230 unpreconditioned iterations amplify the psum reduction-order
    # difference late in the trajectory; the preconditioned test below holds
    # a +-3 band at ~70 iterations
    assert abs(r_d.iters - r_s.iters) <= 0.1 * r_s.iters
    np.testing.assert_allclose(r_d.x, r_s.x, rtol=1e-6, atol=1e-8)
    rel = np.linalg.norm(b - grid.matvec(r_d.x)) / np.linalg.norm(b)
    assert rel < 1e-7


@needs_8
def test_dist_stencil_neumann_uses_fused_msolve_kernel(grid, rng, monkeypatch):
    """The distributed const-factor Neumann msolve applies each triangle's
    whole series as one stencil (P_l, P_u on A's layout, exact diagonal)
    and tracks the single-chip fused-series trajectory."""
    from cuda_mat.parallel import dist_solver
    from cuda_mat.solvers.bicgstab import solve

    calls = []
    orig = dist_solver._make_local_matvec_stencil

    def spy(*a, **kw):
        calls.append(kw.get("sterms"))
        return orig(*a, **kw)

    monkeypatch.setattr(dist_solver, "_make_local_matvec_stencil", spy)
    b = rng.uniform(1.0, 5.0, grid.n)
    cfg = SolverConfig(maxit=2000, tol=1e-8, precond="ilu0_neumann",
                       neumann_terms=3)
    r_d = dist_bicgstab(grid, b, make_mesh(8), cfg, local_engine="stencil")
    assert len(calls) == 3 and calls[0] is None, "fused series not selected"
    assert all(len(st) > 3 for st in calls[1:])   # the series polynomials
    r_s = solve(grid, b, cfg, format="stencil")
    assert r_d.converged and r_s.converged
    assert abs(r_d.iters - r_s.iters) <= max(3, 0.15 * r_s.iters)
    np.testing.assert_allclose(r_d.x, r_s.x, rtol=1e-6, atol=1e-8)
    rel = np.linalg.norm(b - grid.matvec(r_d.x)) / np.linalg.norm(b)
    assert rel < 1e-7


@needs_8
def test_dist_stencil_ilu0_neumann(grid, rng):
    """The production config — flagship stencil matvec + Neumann-ILU(0)
    factors — distributes and tracks the single-chip trajectory."""
    from cuda_mat.solvers.bicgstab import solve

    b = rng.uniform(1.0, 5.0, grid.n)
    cfg = SolverConfig(maxit=2000, tol=1e-8, precond="ilu0_neumann",
                       neumann_terms=3)
    r_d = dist_bicgstab(grid, b, make_mesh(8), cfg, local_engine="stencil")
    r_s = solve(grid, b, cfg, format="stencil")
    assert r_d.converged and r_s.converged
    # per-iteration residuals agree to ~1e-15; the psum reduction-order noise
    # is amplified by the trajectory's late-stage sensitivity (~80 iters)
    assert abs(r_d.iters - r_s.iters) <= max(3, 0.15 * r_s.iters)
    np.testing.assert_allclose(r_d.x, r_s.x, rtol=1e-6, atol=1e-8)
    rel = np.linalg.norm(b - grid.matvec(r_d.x)) / np.linalg.norm(b)
    assert rel < 1e-7


@needs_8
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_dist_xla_engine_matches_single_chip(ndev, rng):
    """The distributed XLA banded engine (halo-exchange DIA, psum dots) on
    1, 2 and 4 virtual devices solves like the single-chip DIA path."""
    from cuda_mat.models.problems import laplacian_2d
    from cuda_mat.solvers.bicgstab import solve

    a = laplacian_2d(24)
    b = rng.uniform(1.0, 5.0, a.n)
    cfg = SolverConfig(maxit=2000, tol=1e-8, precond="jacobi")
    r_d = dist_bicgstab(a, b, make_mesh(ndev), cfg, local_engine="xla")
    r_s = solve(a, b, cfg, format="dia")
    assert r_d.converged and r_s.converged
    assert abs(r_d.iters - r_s.iters) <= 1
    np.testing.assert_allclose(r_d.x, r_s.x, rtol=1e-6, atol=1e-9)


def test_dist_stencil_rejects_bjacobi(grid):
    cfg = SolverConfig(maxit=10, precond="bjacobi_ilu0")
    with pytest.raises(ValueError, match="stencil"):
        dist_bicgstab(grid, np.ones(grid.n),
                      make_mesh(min(4, len(jax.devices()))), cfg,
                      local_engine="stencil")


def test_dist_stencil_rejects_nonstencil(rng):
    from cuda_mat.models.problems import random_diag_nonzero_system

    a, b = random_diag_nonzero_system(64, prob_of_zero=0.7)
    cfg = SolverConfig(maxit=10)
    with pytest.raises(ValueError):
        dist_bicgstab(a, b, make_mesh(min(4, len(jax.devices()))), cfg,
                      local_engine="stencil")


@needs_8
@pytest.mark.parametrize("data", ["float", "dyadic"])
def test_dist_const_msolve_matches_host_series(grid, data, rng):
    """The distributed constant-factor Neumann msolve ``P_u(inv_d ∘ P_l f)``
    on 4 shards (a halo exchange per stencil) equals the two series
    polynomials applied in float64 on the host over the whole
    partition-padded vector.  With dyadic data (few-bit coefficients, inv_d
    and f) every product and sum is exact, so there the two must agree
    bitwise: every row reads its operands from the right place, halos and
    masks included."""
    from functools import partial as _partial

    from jax.sharding import PartitionSpec as P

    from cuda_mat.ops.stencil import (const_factor_terms, neumann_poly_terms,
                                      series_gap, strided_offsets)
    from cuda_mat.parallel.dist_solver import _make_local_msolve_stencil
    from cuda_mat.parallel.partition import RowPartitionedStencil
    from cuda_mat.precond.preconditioners import neumann_factors

    k = 3
    mesh = make_mesh(4)
    axis = mesh.axis_names[0]
    part = RowPartitionedStencil.from_matrix(grid, 4)
    part = RowPartitionedStencil.from_matrix(
        grid, 4, gap=series_gap(part.terms, k))
    low, up, diag_m = neumann_factors(grid)
    polys = []
    for f in (low, up):
        t, _ = const_factor_terms(f.to_dia(max_diags=128), part.c_grid,
                                  part.stride)
        polys.append(strided_offsets(
            neumann_poly_terms(t, k, part.c_grid, part.stride), part.c_grid,
            part.stride))
    invd = part.strided_scatter(1.0 / diag_m, fill=1.0)
    if data == "dyadic":
        polys = [tuple((o, np.round(s * 64) / 64) for o, s in p)
                 for p in polys]
        invd = np.round(invd * 16) / 16
        fh = part.pad_vector(rng.integers(-8, 9, grid.n) / 8.0)
    else:
        fh = part.pad_vector(rng.standard_normal(grid.n))

    sh = jax.sharding.NamedSharding(mesh, P(axis))
    f = jax.jit(_partial(jax.shard_map, mesh=mesh,
                         in_specs=(P(axis), P(axis)), out_specs=P(axis))(
        _make_local_msolve_stencil(part, axis, *polys)))
    out = np.asarray(f(jax.device_put(jnp.asarray(invd), sh),
                       jax.device_put(jnp.asarray(fh), sh)))

    def host_stencil(v, sterms):
        w = max(abs(o) for o, _ in sterms)
        ve = np.pad(v, (w, w))
        y = sum(s * ve[w + o: w + o + v.size] for o, s in sterms)
        return part.pad_vector(part.unpad_vector(y))     # gap + padding mask

    ref = host_stencil(invd * host_stencil(fh, polys[0]), polys[1])
    if data == "dyadic":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


@needs_8
def test_dist_stencil_neumann_exact_pattern_factors(grid, rng):
    """neumann_const_factors=False keeps the restrided exact-pattern factor
    path (XLA DIA engine over restrided streams) working distributed."""
    b = rng.uniform(1.0, 5.0, grid.n)
    cfg = SolverConfig(maxit=2000, tol=1e-6, precond="ilu0_neumann",
                       neumann_terms=3, neumann_const_factors=False)
    r = dist_bicgstab(grid, b, make_mesh(8), cfg, local_engine="stencil")
    assert r.converged
    rel = np.linalg.norm(b - grid.matvec(r.x)) / np.linalg.norm(b)
    assert rel < 1e-5


@needs_8
def test_dist_milu_omega_matches_single_chip(grid, rng):
    """milu_omega flows through the distributed factor path
    (neumann_factors in make_dist_bicgstab) and tracks the single-chip
    trajectory."""
    from cuda_mat.solvers.bicgstab import solve

    b = np.ones(grid.n)
    cfg = SolverConfig(maxit=2000, tol=1e-8, precond="ilu0_neumann",
                       neumann_terms=3, milu_omega=0.97)
    r_d = dist_bicgstab(grid, b, make_mesh(8), cfg, local_engine="stencil")
    r_s = solve(grid, b, cfg, format="stencil")
    assert r_d.converged and r_s.converged
    assert abs(r_d.iters - r_s.iters) <= max(3, 0.15 * r_s.iters)
    np.testing.assert_allclose(r_d.x, r_s.x, rtol=1e-6, atol=1e-8)
