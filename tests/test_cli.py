"""CLI tests (in-process, CPU backend — conftest already forces cpu/x64)."""

import numpy as np
import pytest

from cuda_mat.cli import main
from cuda_mat.models.problems import fixture_path


def test_cli_mat900_ilu(capsys):
    rc = main(["-M", fixture_path("mat900")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "success" in out
    assert "algorithm delta time" in out


def test_cli_mat3_vec3_plain(capsys):
    rc = main(["-M", fixture_path("mat3"), "-V", fixture_path("vec3"),
               "--precond", "none", "-P"])
    out = capsys.readouterr().out
    assert rc == 0
    # known solution (1.1667, 5.6667, -3.8333)
    assert "1.166667" in out and "5.666667" in out and "-3.833333" in out


def test_cli_random_system(capsys):
    rc = main(["-N", "64", "-R", "0.97", "--precond", "jacobi",
               "--maxit", "500"])
    out = capsys.readouterr().out
    # random systems are not guaranteed solvable; accept either outcome but
    # require a clean exit path
    assert rc in (0, 2)


def test_cli_debug_prints_residuals(capsys):
    rc = main(["-M", fixture_path("mat3"), "-V", fixture_path("vec3"),
               "--precond", "none", "-D"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "initial norm" in out


def test_cli_rejects_nonsquare(capsys, tmp_path):
    rc = main(["-M", fixture_path("vec3")])  # 3x1 is not square
    assert rc == 1
    assert "square" in capsys.readouterr().err


def test_cli_rejects_bad_vector_dim(capsys):
    rc = main(["-M", fixture_path("mat900"), "-V", fixture_path("vec3")])
    assert rc == 1
    assert "incorrect dim" in capsys.readouterr().err


def test_cli_bicg_solver(capsys):
    rc = main(["-M", fixture_path("mat3"), "-V", fixture_path("vec3"),
               "--solver", "bicg", "--precond", "none"])
    assert rc == 0
    assert "success" in capsys.readouterr().out


def test_cli_distributed(capsys):
    rc = main(["-M", fixture_path("mat900"), "--devices", "4",
               "--precond", "jacobi"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "success" in out


def test_cli_distributed_rejects_ilu(capsys):
    rc = main(["-M", fixture_path("mat900"), "--devices", "4"])
    assert rc == 1
    assert "bjacobi_ilu0" in capsys.readouterr().err


def test_cli_distributed_ilu0_neumann(capsys):
    rc = main(["-M", fixture_path("mat900"), "--devices", "4",
               "--precond", "ilu0_neumann"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "success" in out
