"""Preconditioners: identity, Jacobi, ILU(0) with blocked triangular solves."""

from cuda_mat.precond.preconditioners import (
    IdentityPreconditioner,
    JacobiPreconditioner,
    ILU0Preconditioner,
    make_preconditioner,
)

__all__ = [
    "IdentityPreconditioner",
    "JacobiPreconditioner",
    "ILU0Preconditioner",
    "make_preconditioner",
]
