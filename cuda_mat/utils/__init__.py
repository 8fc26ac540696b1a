"""Timers, norms, checkpointing, dense QR, and observability helpers."""

from cuda_mat.utils.timing import PhaseTimer, second
from cuda_mat.utils.norms import (vec_norminf, mat_norminf,
                                       csr_mat_norminf, display_matrix)
from cuda_mat.utils.checkpoint import save_checkpoint, load_checkpoint

__all__ = [
    "PhaseTimer",
    "second",
    "vec_norminf",
    "mat_norminf",
    "csr_mat_norminf",
    "display_matrix",
    "save_checkpoint",
    "load_checkpoint",
]
