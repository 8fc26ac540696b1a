"""Regenerate the checked-in trajectory goldens (tests/goldens/*.npz).

Goldens are the f64 numpy-oracle residual trajectories (reference update
order, see reference/cpu_solvers.py) on the fixture set at the reference's
tolerances (tol=1e-6 for the CLI path, 1e-5 for the demo functions —
reference example.cpp:179-180 and :87,:146).  They pin the oracles against
accidental edits; the jitted solvers are compared to the oracles separately
(tests/test_bicgstab.py).

Run: python tests/make_goldens.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

from cuda_mat.io.mmio import load_mm_sparse_matrix
from cuda_mat.models.problems import split_form
from cuda_mat.io.vectors import to_dense_vector
from cuda_mat.reference.cpu_solvers import (bicg_cpu, bicgstab_hform_cpu,
                                                bicgstab_ilu_cpu,
                                                bicgstab_split_cpu)
from cuda_mat.precond.preconditioners import milu0_factorize

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "..", "data")
OUT = os.path.join(HERE, "goldens")


def _traj(r):
    return dict(iters=np.int64(r.iters), converged=np.bool_(r.converged),
                residual=np.float64(r.residual),
                history=np.asarray(r.residual_history, dtype=np.float64),
                x=np.asarray(r.x, dtype=np.float64))


def main():
    os.makedirs(OUT, exist_ok=True)
    mat3 = load_mm_sparse_matrix(os.path.join(DATA, "mat3.mtx"))
    vec3 = to_dense_vector(load_mm_sparse_matrix(os.path.join(DATA, "vec3.mtx")))
    mat3_a0 = load_mm_sparse_matrix(os.path.join(DATA, "mat3_A0.mtx"))
    vec3_d = to_dense_vector(load_mm_sparse_matrix(os.path.join(DATA, "vec3_d.mtx")))
    mat900 = load_mm_sparse_matrix(os.path.join(DATA, "mat900.mtx"))
    mat10000 = load_mm_sparse_matrix(os.path.join(DATA, "mat10000.mtx"))

    goldens = {
        # demo fn conditions: maxit=200/2000, tol=1e-5 (example.cpp:87,:146)
        "mat3_hform": bicgstab_hform_cpu(mat3, vec3, maxit=200, tol=1e-5),
        "mat3_split": bicgstab_split_cpu(mat3_a0, vec3_d, np.ones(3), vec3,
                                         maxit=2000, tol=1e-5),
        # (no mat3 ILU golden: mat3 stores a zero diagonal entry in row 1,
        #  so ILU(0) has a structural zero pivot — the reference's demo test1
        #  would hit the same pivot in cusparseDcsrilu0)
        # CLI conditions: maxit=2000, tol=1e-6 (example.cpp:179-180)
        "mat900_ilu": bicgstab_ilu_cpu(mat900, np.ones(900)),
        "mat900_hform": bicgstab_hform_cpu(mat900, np.ones(900)),
        "mat10000_ilu": bicgstab_ilu_cpu(mat10000, np.ones(10000)),
        "mat900_bicg": bicg_cpu(mat900, np.ones(900)),
        # remaining entry points on the headline fixture
        "mat10000_hform": bicgstab_hform_cpu(mat10000, np.ones(10000)),
        "mat10000_split": bicgstab_split_cpu(
            *split_form(mat10000), np.ones(10000), np.ones(10000),
            maxit=2000, tol=1e-6),
        "mat10000_bicg": bicg_cpu(mat10000, np.ones(10000)),
        # relaxed-MILU(0.97) trajectory (the round-4 flagship preconditioner
        # option, beyond-reference; factor values are native<->numpy tested
        # in test_neumann.py — this pins the resulting trajectory too)
        "mat900_milu097": bicgstab_ilu_cpu(
            mat900, np.ones(900), mvals=milu0_factorize(mat900, 0.97)),
    }
    for name, r in goldens.items():
        path = os.path.join(OUT, f"{name}.npz")
        np.savez_compressed(path, **_traj(r))
        print(f"{name}: iters={r.iters} converged={r.converged} "
              f"residual={r.residual:.6e} -> {os.path.relpath(path)}")


if __name__ == "__main__":
    main()
