"""I/O: Matrix Market files, the OMP side-module's custom text formats,
and workload generators."""

from cuda_mat.io.mmio import load_mm_sparse_matrix, read_mm, write_mm
from cuda_mat.io.vectors import to_dense_vector
from cuda_mat.io import omp_format

__all__ = [
    "load_mm_sparse_matrix",
    "read_mm",
    "write_mm",
    "to_dense_vector",
    "omp_format",
]
