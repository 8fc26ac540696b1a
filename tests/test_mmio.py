"""Matrix Market ingestion tests (SURVEY §4 implication 1): loader vs
hand-computed CSR for the mat3 family, symmetrization nnz counts, CSR
invariant checks."""

import io

import numpy as np
import pytest

from cuda_mat.formats.coo import COOMatrix
from cuda_mat.formats.csr import CSRMatrix, verify_pattern
from cuda_mat.io.mmio import (load_mm_sparse_matrix, read_mm, write_mm,
                                  write_mm_dense_vector)
from cuda_mat.io.vectors import to_dense_vector
from cuda_mat.io import omp_format
from cuda_mat.models.problems import fixture_path


# Hand-computed CSR for mat3.mtx (reference mat3.mtx:7-15):
# [[1,2,3],[5,0,1],[1,1,1]]
MAT3_DENSE = np.array([[1., 2, 3], [5, 0, 1], [1, 1, 1]])


def test_mat3_csr(mat3):
    assert (mat3.n, mat3.m, mat3.nnz) == (3, 3, 8)
    np.testing.assert_array_equal(mat3.indptr, [0, 3, 5, 8])
    np.testing.assert_array_equal(mat3.indices, [0, 1, 2, 0, 2, 0, 1, 2])
    np.testing.assert_allclose(mat3.to_dense(), MAT3_DENSE)


def test_vec3_dense(vec3):
    np.testing.assert_allclose(vec3, [1.0, 2.0, 3.0])


def test_vec3_d_sparse_to_dense(vec3_d):
    # vec3_d has entries only at rows 1 and 3 (reference vec3_d.mtx:7-9)
    np.testing.assert_allclose(vec3_d, [1.0, 0.0, 1.0])


def test_mat3_a0_plus_d_identity(mat3, mat3_a0, vec3_d):
    """The fixture pair encodes A = A0 + diag(d) (SURVEY §4: algebraic
    identity between mat3/mat3_A0/vec3_d)."""
    np.testing.assert_allclose(mat3_a0.to_dense() + np.diag(vec3_d),
                               mat3.to_dense())


def test_mat900_symmetrization(mat900):
    # stored nnz 4322 -> 7744 after mirroring (reference mat900.mtx:7,
    # mmio_wrapper.h:172-230)
    assert mat900.nnz == 7744
    assert (mat900.n, mat900.m) == (900, 900)
    d = mat900.to_dense()
    np.testing.assert_allclose(d, d.T)


def test_mat10000_symmetrization(mat10000):
    assert mat10000.nnz == 49600
    assert mat10000.n == 10000
    # banded: diag 4, off-diagonals -1 at offsets ±1 (broken each 100) and ±100
    dia = mat10000.to_dia()
    np.testing.assert_array_equal(dia.offsets, [-100, -1, 0, 1, 100])
    np.testing.assert_allclose(dia.data[2], 4.0)


def test_no_symmetrize_flag():
    m = load_mm_sparse_matrix(fixture_path("mat900"), symmetrize=False,
                              prefer_native=False)
    assert m.nnz == 4322


def test_reject_bad_banner():
    with pytest.raises(ValueError):
        read_mm(io.StringIO("%%NotMatrixMarket matrix coordinate real general\n"))


def test_reject_pattern_field():
    f = io.StringIO("%%MatrixMarket matrix coordinate pattern general\n3 3 1\n1 1\n")
    with pytest.raises(ValueError):
        read_mm(f)


def test_reject_dense_array():
    f = io.StringIO("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(ValueError):
        read_mm(f)


def test_skew_symmetrization():
    f = io.StringIO("%%MatrixMarket matrix coordinate real skew-symmetric\n"
                    "3 3 2\n2 1 5.0\n3 2 -2.0\n")
    _, coo = read_mm(f)
    coo = coo.symmetrized("skew-symmetric")
    d = coo.to_csr().to_dense()
    np.testing.assert_allclose(d, -d.T)
    assert d[1, 0] == 5.0 and d[0, 1] == -5.0


def test_write_read_roundtrip(tmp_path, mat3):
    p = tmp_path / "rt.mtx"
    write_mm(str(p), mat3)
    back = load_mm_sparse_matrix(str(p), prefer_native=False)
    np.testing.assert_allclose(back.to_dense(), mat3.to_dense())


def test_write_dense_vector_roundtrip(tmp_path):
    p = tmp_path / "v.mtx"
    write_mm_dense_vector(str(p), np.array([1.0, 0.0, 2.5]))
    _, coo = read_mm(str(p))
    np.testing.assert_allclose(to_dense_vector(coo.to_csr()), [1.0, 0.0, 2.5])


def test_verify_pattern_rejects_bad_indptr():
    with pytest.raises(ValueError):
        verify_pattern(2, 2, np.array([0, 2, 1]), np.array([0, 1]))
    with pytest.raises(ValueError):
        verify_pattern(2, 3, np.array([0, 1, 2]), np.array([0, 1, 0]))


def test_verify_pattern_rejects_unsorted_cols():
    with pytest.raises(ValueError):
        verify_pattern(1, 2, np.array([0, 2]), np.array([1, 0]))


def test_omp_format_roundtrip(tmp_path, mat3):
    """The bicstab_omp custom text formats (reference bicstab.cpp:198-227)."""
    mp = tmp_path / "mat.txt"
    vp = tmp_path / "vec.txt"
    omp_format.write_matrix(str(mp), mat3)
    omp_format.write_vector(str(vp), np.array([1.0, 2.0, 3.0]))
    m = omp_format.read_matrix(str(mp))
    v = omp_format.read_vector(str(vp))
    np.testing.assert_allclose(m.to_dense(), mat3.to_dense())
    np.testing.assert_allclose(v, [1.0, 2.0, 3.0])
