"""Device (JAX) operators and kernels: SpMV variants, triangular solves.

This layer replaces the reference's vendor kernel layer (cuSPARSE csrmv /
csrsv_solve / csrilu0 + cuBLAS BLAS1, SURVEY §2 C5) with plain ``jnp``/``lax``
that XLA compiles and fuses: gather/segment-sum SpMV formulations, the
no-gather DIA SpMV and the matrix-free constant stencil for the banded hot
path, and BLAS1 vector ops fused between SpMV calls.
"""

from cuda_mat.ops.operators import (
    CSROperator,
    ELLOperator,
    DIAOperator,
    SplitOperator,
    DenseOperator,
    make_operator,
)
from cuda_mat.ops.trisolve import BlockTriangularSolver

__all__ = [
    "CSROperator",
    "ELLOperator",
    "DIAOperator",
    "SplitOperator",
    "DenseOperator",
    "make_operator",
    "BlockTriangularSolver",
]
