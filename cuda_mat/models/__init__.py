"""Problem/workload model families (generators + named fixtures)."""

from cuda_mat.models.problems import (
    gen_rand_csr_matrix,
    gen_rand_vector,
    random_diag_nonzero_system,
    laplacian_2d,
    banded_laplacian,
    fixture_path,
)

__all__ = [
    "gen_rand_csr_matrix",
    "gen_rand_vector",
    "random_diag_nonzero_system",
    "laplacian_2d",
    "banded_laplacian",
    "fixture_path",
]
