"""JIT-compiled iterative solvers (BiCGSTAB family + BiCG)."""

from cuda_mat.solvers.result import SolveResult, SolverStatus
from cuda_mat.solvers.bicgstab import (
    bicgstab,
    bicgstab_split,
    bicgstab_lu_precond,
    make_solver,
    PreparedSolver,
    solve,
)
from cuda_mat.solvers.bicg import bicg
from cuda_mat.solvers.refine import solve_refined

__all__ = [
    "SolveResult",
    "SolverStatus",
    "bicgstab",
    "bicgstab_split",
    "bicgstab_lu_precond",
    "bicg",
    "solve",
    "make_solver",
    "PreparedSolver",
    "solve_refined",
]
