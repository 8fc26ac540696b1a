"""Native (C++) loader/ILU tests: exact agreement with the Python oracles.

Skipped when the shared library is not built
(``make -C cuda_mat/native``)."""

import numpy as np
import pytest

from cuda_mat.io.mmio import load_mm_sparse_matrix, write_mm
from cuda_mat.models.problems import fixture_path, gen_rand_csr_matrix
from cuda_mat.native import loader as native
from cuda_mat.reference.cpu_solvers import ilu0_factorize

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


@pytest.mark.parametrize("name", ["mat3", "vec3", "mat3_A0", "vec3_d",
                                  "mat900", "mat10000"])
def test_native_load_matches_python(name):
    py = load_mm_sparse_matrix(fixture_path(name), prefer_native=False)
    nat = native.load_mm_sparse_matrix(fixture_path(name))
    assert (nat.n, nat.m, nat.nnz) == (py.n, py.m, py.nnz)
    np.testing.assert_array_equal(nat.indptr, py.indptr)
    np.testing.assert_array_equal(nat.indices, py.indices)
    np.testing.assert_array_equal(nat.data, py.data)


def test_native_no_symmetrize():
    nat = native.load_mm_sparse_matrix(fixture_path("mat900"),
                                       symmetrize=False)
    assert nat.nnz == 4322


def test_native_rejects_garbage(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text("hello world\n1 2 3\n")
    with pytest.raises(ValueError):
        native.load_mm_sparse_matrix(str(p))


def test_native_rejects_truncated(tmp_path):
    p = tmp_path / "trunc.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n3 3 5\n1 1 1.0\n")
    with pytest.raises(ValueError):
        native.load_mm_sparse_matrix(str(p))


def test_native_rejects_out_of_range(tmp_path):
    p = tmp_path / "oor.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n3 3 1\n4 1 1.0\n")
    with pytest.raises(ValueError):
        native.load_mm_sparse_matrix(str(p))


def test_native_skew(tmp_path):
    p = tmp_path / "skew.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real skew-symmetric\n"
                 "3 3 2\n2 1 5.0\n3 2 -2.0\n")
    nat = native.load_mm_sparse_matrix(str(p))
    d = nat.to_dense()
    np.testing.assert_allclose(d, -d.T)
    assert d[1, 0] == 5.0 and d[0, 1] == -5.0


@pytest.mark.parametrize("name", ["mat900", "mat10000"])
def test_native_ilu0_matches_python(name):
    a = load_mm_sparse_matrix(fixture_path(name), prefer_native=False)
    py = ilu0_factorize(a)
    nat = native.ilu0_factorize(a)
    np.testing.assert_allclose(nat, py, rtol=1e-14, atol=1e-15)


def test_native_ilu0_random():
    from cuda_mat.formats.csr import CSRMatrix

    a0 = gen_rand_csr_matrix(80, 80, 0.9, 0.5, 2.0, seed=13)
    a = CSRMatrix.from_dense(a0.to_dense() + 40 * np.eye(80))
    np.testing.assert_allclose(native.ilu0_factorize(a), ilu0_factorize(a),
                               rtol=1e-13, atol=1e-14)


def test_native_ilu0_missing_diag(mat3):
    with pytest.raises(ValueError):
        native.ilu0_factorize(mat3)


def test_ilu0_zero_pivot_at_use_both_paths():
    """A diagonal that is zero AT THE MOMENT it is used as a pivot is refused
    by BOTH the native factorizer and the Python oracle (aligned
    contract).  Here (1,1)=0 stored, row 1 is not updated by
    elimination (no (1,0) entry), and row 2 eliminates with pivot 1."""
    from cuda_mat.formats.coo import COOMatrix
    from cuda_mat.formats.csr import CSRMatrix

    rows = np.array([0, 1, 2, 2], np.int32)
    cols = np.array([0, 1, 1, 2], np.int32)
    data = np.array([2.0, 0.0, 1.0, 3.0])   # explicit zero at (1,1)
    a = CSRMatrix.from_coo(COOMatrix(3, 3, rows, cols, data))
    with pytest.raises(ValueError):
        ilu0_factorize(a)
    with pytest.raises(ValueError):
        native.ilu0_factorize(a)


def test_ilu0_transient_zero_diag_factorizes_both_paths():
    """A stored-zero diagonal that becomes nonzero during elimination before
    any row uses it as a pivot must factorize in both paths — the reason the
    pivot check is lazy, not eager."""
    from cuda_mat.formats.coo import COOMatrix
    from cuda_mat.formats.csr import CSRMatrix

    rows = np.array([0, 0, 1, 1, 1, 2, 2], np.int32)
    cols = np.array([0, 1, 0, 1, 2, 1, 2], np.int32)
    # (1,1)=0 stored; elimination with row 0 makes it -0.5 before row 2
    # uses it as a pivot
    data = np.array([2.0, 1.0, 1.0, 0.0, 1.0, 1.0, 3.0])
    a = CSRMatrix.from_coo(COOMatrix(3, 3, rows, cols, data))
    py = ilu0_factorize(a)
    assert np.all(np.isfinite(py))
    np.testing.assert_allclose(native.ilu0_factorize(a), py, rtol=1e-15)


def test_native_roundtrip_written_file(tmp_path):
    a = gen_rand_csr_matrix(30, 30, 0.8, -2.0, 2.0, seed=5)
    p = tmp_path / "rt.mtx"
    write_mm(str(p), a)
    nat = native.load_mm_sparse_matrix(str(p))
    np.testing.assert_allclose(nat.to_dense(), a.to_dense())


def test_stale_library_degrades_to_unavailable(monkeypatch):
    """A prebuilt .so missing a newer symbol raises AttributeError during
    _configure; the loader must treat that like an unbuilt library (regress:
    available() crashed instead of returning False, killing the documented
    pure-Python fallback for every caller)."""
    from cuda_mat.native import loader

    def boom(lib):
        raise AttributeError("undefined symbol: cmt_somethingnew")

    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_load_failed", False)
    monkeypatch.setattr(loader, "_configure", boom)
    assert loader.available() is False
    # and the failure is sticky (no re-raise on later calls)
    assert loader.available() is False
