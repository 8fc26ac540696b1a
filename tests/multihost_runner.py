"""Per-process body of the 2-process multi-host smoke test (SURVEY §2
distributed component 4).

Launched by tests/test_multihost.py as ``python multihost_runner.py
<process_id> <num_processes> <coordinator_port>``.  Each process owns 2
virtual CPU devices; together they form a 4-device global mesh over the
``jax.distributed`` process group — the same code path several GPU hosts
use (reference analogue: the one-time device init of
example.cpp:237, lifted to a process group).
"""

import os
import sys


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from cuda_mat.config import SolverConfig
    from cuda_mat.models.problems import banded_laplacian
    from cuda_mat.parallel.dist_solver import (dist_bicgstab, dist_spmv)
    from cuda_mat.parallel.mesh import init_distributed, make_mesh

    init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc, len(jax.devices())

    a = banded_laplacian(20)                       # n=400, w=20
    rng = np.random.default_rng(7)
    x = rng.standard_normal(a.n)

    mesh = make_mesh()                             # all 4 global devices
    y = dist_spmv(a, x, mesh, dtype="float64")
    np.testing.assert_allclose(y, a.matvec(x), rtol=1e-12, atol=1e-12)

    b = rng.uniform(1.0, 5.0, a.n)
    cfg = SolverConfig(maxit=2000, tol=1e-8, precond="jacobi")
    res = dist_bicgstab(a, b, mesh, cfg)
    assert res.converged, res.status
    rel = np.linalg.norm(b - a.matvec(res.x)) / np.linalg.norm(b)
    assert rel < 1e-6, rel

    # ilu0_neumann on the XLA banded engine through the real multi-process
    # group
    cfg_n = SolverConfig(maxit=2000, tol=1e-8, precond="ilu0_neumann",
                         neumann_terms=3)
    res_n = dist_bicgstab(a, b, mesh, cfg_n, local_engine="xla")
    assert res_n.converged, res_n.status
    rel_n = np.linalg.norm(b - a.matvec(res_n.x)) / np.linalg.norm(b)
    assert rel_n < 1e-6, rel_n

    # the flagship distributed stencil engine across processes
    from cuda_mat.models.problems import grid_laplacian

    g = grid_laplacian(8, 126)
    bg = rng.uniform(1.0, 5.0, g.n)
    res_s = dist_bicgstab(g, bg, mesh, cfg_n, local_engine="stencil")
    assert res_s.converged, res_s.status
    rel_s = np.linalg.norm(bg - g.matvec(res_s.x)) / np.linalg.norm(bg)
    assert rel_s < 1e-6, rel_s
    print(f"MULTIHOST_OK pid={pid} iters={res.iters} rel={rel:.2e}"
          f" neumann_iters={res_n.iters} stencil_iters={res_s.iters}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
