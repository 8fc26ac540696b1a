"""bench.py helper functions (they produce the benchmark's numbers — the
medians must keep working on the CPU backend too)."""

import numpy as np

from bench import _median_solve
from cuda_mat.config import SolverConfig
from cuda_mat.solvers.bicgstab import make_solver


def test_median_solve_returns_median(mat900):
    ps = make_solver(mat900, SolverConfig(maxit=2000, tol=1e-6,
                                          precond="ilu0"))
    res = _median_solve(ps, np.ones(mat900.n), reps=3)
    assert res.converged
    assert res.dt_alg > 0


def test_bench_refuses_to_run_without_gpu():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(repo, "bench.py")],
                       capture_output=True, text=True, env=env, cwd=repo,
                       timeout=240)
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr and not p.stdout.strip()
