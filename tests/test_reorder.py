"""RCM reordering: bandwidth reduction + exactness of the permuted solve."""

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_mat.config import SolverConfig
from cuda_mat.formats.csr import CSRMatrix
from cuda_mat.formats.reorder import (bandwidth, permute_csr,
                                          permute_vector, rcm_permutation,
                                          unpermute_vector)
from cuda_mat.models.problems import banded_laplacian
from cuda_mat.solvers.bicgstab import solve


def _shuffled_laplacian(k, seed=0):
    """A banded Laplacian whose rows/cols were randomly permuted — the
    worst-case 'banded-able but badly ordered' input."""
    a = banded_laplacian(k)
    rng = np.random.default_rng(seed)
    p = rng.permutation(a.n).astype(np.int64)
    return permute_csr(a, p), a


def test_rcm_recovers_narrow_band():
    shuffled, orig = _shuffled_laplacian(40)  # n=1600, true bandwidth 40
    assert bandwidth(shuffled) > 10 * bandwidth(orig)
    perm = rcm_permutation(shuffled)
    reordered = permute_csr(shuffled, perm)
    # RCM restores a bandwidth within a small factor of the optimum
    assert bandwidth(reordered) <= 3 * bandwidth(orig)


def test_permutation_roundtrip():
    rng = np.random.default_rng(1)
    v = rng.standard_normal(100)
    perm = rng.permutation(100).astype(np.int64)
    np.testing.assert_array_equal(
        unpermute_vector(permute_vector(v, perm), perm), v)


def test_permute_csr_is_similarity():
    shuffled, _ = _shuffled_laplacian(8, seed=2)
    perm = rcm_permutation(shuffled)
    pa = permute_csr(shuffled, perm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shuffled.n)
    # (P A P^T)(P x) == P (A x)
    np.testing.assert_allclose(pa.matvec(permute_vector(x, perm)),
                               permute_vector(shuffled.matvec(x), perm),
                               rtol=1e-12)


@pytest.mark.parametrize("precond", ["none", "jacobi", "ilu0"])
def test_reordered_solve_exact(precond):
    shuffled, _ = _shuffled_laplacian(12, seed=4)  # n=144
    rng = np.random.default_rng(5)
    b = rng.uniform(1.0, 5.0, shuffled.n)
    cfg = SolverConfig(maxit=2000, tol=1e-10, precond=precond)
    res = solve(shuffled, b, cfg.replace(reorder="rcm"))
    assert res.converged
    # x is scattered back to the ORIGINAL ordering: check A x == b directly
    rel = np.linalg.norm(b - shuffled.matvec(res.x)) / np.linalg.norm(b)
    assert rel < 1e-8


def test_reorder_rejects_unknown():
    a = banded_laplacian(4)
    with pytest.raises(ValueError):
        solve(a, np.ones(a.n), SolverConfig(reorder="amd"))


def test_rcm_disconnected_components():
    # block-diagonal matrix = 2 disconnected graph components
    a1 = banded_laplacian(4).to_dense()
    n1 = a1.shape[0]
    d = np.zeros((2 * n1, 2 * n1))
    d[:n1, :n1] = a1
    d[n1:, n1:] = a1
    a = CSRMatrix.from_dense(d)
    perm = rcm_permutation(a)
    assert sorted(perm.tolist()) == list(range(2 * n1))
    assert bandwidth(permute_csr(a, perm)) <= bandwidth(a)
