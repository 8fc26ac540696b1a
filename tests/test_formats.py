"""Format container tests: conversions agree with dense, matvec oracles."""

import numpy as np
import pytest

from cuda_mat.formats.csr import CSRMatrix
from cuda_mat.models.problems import (banded_laplacian, gen_rand_csr_matrix,
                                          laplacian_2d,
                                          random_diag_nonzero_system)


@pytest.fixture(scope="module")
def rand_csr():
    return gen_rand_csr_matrix(50, 50, probability_of_zero=0.8, vmin=-2.0,
                               vmax=2.0, seed=7)


def test_csr_from_dense_roundtrip(rand_csr):
    d = rand_csr.to_dense()
    back = CSRMatrix.from_dense(d)
    np.testing.assert_allclose(back.to_dense(), d)


def test_csr_matvec(rand_csr, rng):
    x = rng.standard_normal(50)
    np.testing.assert_allclose(rand_csr.matvec(x), rand_csr.to_dense() @ x,
                               rtol=1e-13, atol=1e-12)


def test_ell_roundtrip_and_matvec(rand_csr, rng):
    ell = rand_csr.to_ell()
    np.testing.assert_allclose(ell.to_dense(), rand_csr.to_dense())
    x = rng.standard_normal(50)
    np.testing.assert_allclose(ell.matvec(x), rand_csr.matvec(x), rtol=1e-13, atol=1e-12)


def test_dia_roundtrip_and_matvec(rng):
    a = banded_laplacian(10)  # 100x100, offsets ±1, ±10, 0
    dia = a.to_dia()
    assert set(int(o) for o in dia.offsets) == {-10, -1, 0, 1, 10}
    np.testing.assert_allclose(dia.to_dense(), a.to_dense())
    x = rng.standard_normal(100)
    np.testing.assert_allclose(dia.matvec(x), a.matvec(x), rtol=1e-13, atol=1e-12)


def test_bsr_roundtrip_and_matvec(rand_csr, rng):
    for bs in (2, 3, 8):
        bsr = rand_csr.to_bsr(bs)
        np.testing.assert_allclose(bsr.to_dense(), rand_csr.to_dense())
        x = rng.standard_normal(50)
        np.testing.assert_allclose(bsr.matvec(x), rand_csr.matvec(x),
                                   rtol=1e-13, atol=1e-12)


def test_transpose(rand_csr):
    np.testing.assert_allclose(rand_csr.transpose().to_dense(),
                               rand_csr.to_dense().T)


def test_split_diag(mat3):
    a0, d = mat3.split_diag()
    np.testing.assert_allclose(a0.to_dense() + np.diag(d), mat3.to_dense())
    assert np.all(np.diag(a0.to_dense()) == 0)


def test_split_diag_matches_fixture(mat3, mat3_a0, vec3_d):
    a0, d = mat3.split_diag()
    np.testing.assert_allclose(a0.to_dense(), mat3_a0.to_dense())
    np.testing.assert_allclose(d, vec3_d)


def test_from_fn_matches_reference_recipe():
    """fill_csr_matrix equivalent (reference pbicgstab.h:57-76)."""
    a = CSRMatrix.from_fn(4, 4, lambda i, j: float(i == j) * (i + 1), eps=1e-3)
    np.testing.assert_allclose(a.to_dense(), np.diag([1.0, 2, 3, 4]))


def test_random_diag_nonzero_system():
    a, b = random_diag_nonzero_system(64, prob_of_zero=0.9, seed=3)
    d = np.diag(a.to_dense())
    assert np.all(d >= 1.0) and np.all(d <= 10.0)
    assert b.shape == (64,)


def test_laplacian_2d_matches_mat900(mat900):
    np.testing.assert_allclose(laplacian_2d(30).to_dense(), mat900.to_dense())


def test_banded_laplacian_matches_mat10000(mat10000):
    gen = banded_laplacian(100)
    assert gen.nnz == mat10000.nnz
    np.testing.assert_allclose(gen.to_dense()[:500, :500],
                               mat10000.to_dense()[:500, :500])


def test_duplicate_entries_rejected_without_sum():
    from cuda_mat.formats.coo import COOMatrix

    coo = COOMatrix(2, 2, [0, 0], [1, 1], [1.0, 2.0])
    with pytest.raises(ValueError):
        coo.to_csr()
    summed = coo.to_csr(sum_duplicates=True)
    assert summed.nnz == 1
    np.testing.assert_allclose(summed.to_dense(), [[0, 3.0], [0, 0]])
