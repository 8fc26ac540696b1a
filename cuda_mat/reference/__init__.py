"""Pure-numpy reference solvers — the convergence-trajectory oracles.

These follow the *exact update order* of the reference implementations so the
JAX solvers can be tested against their residual trajectories and
iteration counts (SURVEY §4 test strategy, item 3).
"""

from cuda_mat.reference.cpu_solvers import (
    bicg_cpu,
    bicgstab_hform_cpu,
    bicgstab_split_cpu,
    bicgstab_ilu_cpu,
    ilu0_factorize,
    solve_lower_unit,
    solve_upper,
)

__all__ = [
    "bicg_cpu",
    "bicgstab_hform_cpu",
    "bicgstab_split_cpu",
    "bicgstab_ilu_cpu",
    "ilu0_factorize",
    "solve_lower_unit",
    "solve_upper",
]
