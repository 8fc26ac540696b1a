"""CLI extensions: omp-format ingestion, checkpoint/resume."""

import numpy as np

from cuda_mat.cli import main
from cuda_mat.io import omp_format
from cuda_mat.models.problems import fixture_path, banded_laplacian


def test_cli_omp_format(tmp_path, capsys, rng):
    a = banded_laplacian(8)
    b = rng.uniform(1.0, 5.0, 64)
    mp, vp = str(tmp_path / "mat.txt"), str(tmp_path / "vec.txt")
    omp_format.write_matrix(mp, a)
    omp_format.write_vector(vp, b)
    rc = main(["-M", mp, "-V", vp, "--omp-format", "--solver", "bicg",
               "--precond", "none"])
    assert rc == 0
    assert "success" in capsys.readouterr().out


def test_cli_checkpoint_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    rc = main(["-M", fixture_path("mat900"), "--precond", "none",
               "--maxit", "10", "--tol", "1e-14", "--checkpoint", ck])
    assert rc == 2  # not converged in 10 iters at 1e-14
    capsys.readouterr()
    rc = main(["-M", fixture_path("mat900"), "--precond", "none",
               "--resume", ck])
    out = capsys.readouterr().out
    assert rc == 0
    assert "resuming" in out and "success" in out


def test_cli_reorder_rcm(tmp_path, capsys):
    """--reorder rcm end-to-end through the CLI."""
    from cuda_mat.cli import main

    rc = main(["-M", "data/mat900.mtx", "--reorder", "rcm",
               "--platform", "cpu", "--x64"])
    assert rc == 0
    assert "iterations" in capsys.readouterr().out


def test_cli_format_bell(capsys):
    """--format bell forces the blocked-ELL operator."""
    from cuda_mat.cli import main

    rc = main(["-M", "data/mat900.mtx", "--format", "bell",
               "--precond", "none", "--platform", "cpu", "--x64"])
    assert rc == 0
    assert "iterations" in capsys.readouterr().out


def test_cli_neumann_exact_factors(capsys):
    from cuda_mat.cli import main

    rc = main(["-M", "data/mat900.mtx", "--precond", "ilu0_neumann",
               "--format", "stencil", "--neumann-exact-factors",
               "--platform", "cpu", "--x64"])
    assert rc == 0
    assert "iterations" in capsys.readouterr().out


def test_cli_hints_refine_when_true_residual_misses(capsys, monkeypatch):
    """When the recursive residual converges but the f64 true residual
    misses tol by >10x (f32 drift), the CLI points at --refine."""
    from cuda_mat.cli import main

    rc = main(["-M", "data/mat10000.mtx", "--dtype", "float32",
               "--tol", "1e-6", "--platform", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "rerun with --refine" in out
