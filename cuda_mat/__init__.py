"""cuda_mat — a sparse linear-algebra framework in JAX for NVIDIA GPUs.

A re-design of the capabilities of the reference CUDA library ``cuda-mat``
(preconditioned BiCGSTAB solver for sparse ``Ax = b``): JAX/XLA for the
solver loops (one ``lax.while_loop`` under ``jit``, so per-iteration scalars
never round-trip to the host, unlike the reference which syncs ~6 host
scalars per iteration — see reference pbicgstab.cu:81,106,111,135-136,142),
XLA-fused SpMV formulations (DIA, matrix-free constant stencil) for the hot
path, and ``shard_map``/``psum``/``ppermute`` over a ``jax.sharding.Mesh``
for multi-device row-partitioned operation.

Public API (mirrors the reference's three solver entry points,
reference pbicgstab.h:113-120):

- :func:`bicgstab`                — plain BiCGSTAB on CSR (h-form loop)
- :func:`bicgstab_split`          — BiCGSTAB on ``A = A0 + diag(d)``
- :func:`bicgstab_lu_precond`     — ILU(0)-preconditioned BiCGSTAB
- :func:`load_mm_sparse_matrix`   — Matrix Market ingestion → CSR
"""

from cuda_mat.formats import (
    CSRMatrix,
    COOMatrix,
    ELLMatrix,
    DIAMatrix,
    BSRMatrix,
)
from cuda_mat.io.mmio import load_mm_sparse_matrix, read_mm, write_mm
from cuda_mat.io.vectors import to_dense_vector
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
from cuda_mat.config import SolverConfig, use_x64

__version__ = "0.1.0"

__all__ = [
    "CSRMatrix",
    "COOMatrix",
    "ELLMatrix",
    "DIAMatrix",
    "BSRMatrix",
    "load_mm_sparse_matrix",
    "read_mm",
    "write_mm",
    "to_dense_vector",
    "SolveResult",
    "SolverStatus",
    "bicgstab",
    "bicgstab_split",
    "bicgstab_lu_precond",
    "solve",
    "make_solver",
    "PreparedSolver",
    "solve_refined",
    "bicg",
    "SolverConfig",
    "use_x64",
]
