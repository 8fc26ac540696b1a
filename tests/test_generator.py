"""Generator tool tests (C14 equivalent)."""

import io
import sys

import numpy as np
import pytest

from cuda_mat.generator import main
from cuda_mat.io import omp_format
from cuda_mat.io.mmio import load_mm_sparse_matrix


def test_stdin_config_vector(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("0 30 -10 10 0.5"))
    assert main([]) == 0
    tok = capsys.readouterr().out.split()
    assert int(tok[0]) == 30 and len(tok) == 31


def test_matrix_omp_format_roundtrip(tmp_path):
    p = str(tmp_path / "m.txt")
    assert main(["--kind", "matrix", "--dim", "25", "--zero-prob", "0.8",
                 "-o", p]) == 0
    m = omp_format.read_matrix(p)
    assert m.n == 25


def test_laplacian_mm(tmp_path):
    p = str(tmp_path / "lap.mtx")
    assert main(["--kind", "laplacian", "--side", "10", "--mm", "-o", p]) == 0
    a = load_mm_sparse_matrix(p)
    assert a.n == 100
    d = a.to_dia()
    assert set(int(o) for o in d.offsets) == {-10, -1, 0, 1, 10}


def test_vector_mm(tmp_path):
    p = str(tmp_path / "v.mtx")
    assert main(["--kind", "vector", "--dim", "12", "--zero-prob", "0.0",
                 "--mm", "-o", p]) == 0
    from cuda_mat.io.mmio import read_mm
    from cuda_mat.io.vectors import to_dense_vector

    _, coo = read_mm(p)
    assert to_dense_vector(coo.to_csr()).shape == (12,)


def test_bad_stdin(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("1 2"))
    assert main([]) == 1
