"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Per SURVEY §4 item 4: distributed code paths are exercised without a cluster
via ``--xla_force_host_platform_device_count``; float64 is required to match
the reference's double-precision trajectories.  Tests marked ``gpu`` need the
card and skip here; on a GPU machine ``JAX_PLATFORMS=cuda python -m pytest
-m gpu tests/`` runs them.
"""

import os

# must happen before jax import
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags +
                               " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Build the native C++ library if absent (it is not committed to git) so
# test_native.py exercises the real FFI path.
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_native_dir = os.path.join(_repo, "cuda_mat", "native")
if not os.path.exists(os.path.join(_native_dir, "libcudamat_native.so")):
    import subprocess

    subprocess.run(["make", "-C", _native_dir], capture_output=True,
                   check=False)

from cuda_mat.models.problems import fixture_path  # noqa: E402
from cuda_mat.io.mmio import load_mm_sparse_matrix  # noqa: E402
from cuda_mat.io.vectors import to_dense_vector  # noqa: E402
from cuda_mat.io.mmio import read_mm  # noqa: E402


@pytest.fixture(scope="session")
def mat3():
    return load_mm_sparse_matrix(fixture_path("mat3"))


@pytest.fixture(scope="session")
def vec3():
    _, coo = read_mm(fixture_path("vec3"))
    return to_dense_vector(coo.to_csr())


@pytest.fixture(scope="session")
def mat3_a0():
    return load_mm_sparse_matrix(fixture_path("mat3_A0"))


@pytest.fixture(scope="session")
def vec3_d():
    _, coo = read_mm(fixture_path("vec3_d"))
    return to_dense_vector(coo.to_csr())


@pytest.fixture(scope="session")
def mat900():
    return load_mm_sparse_matrix(fixture_path("mat900"))


@pytest.fixture(scope="session")
def mat10000():
    return load_mm_sparse_matrix(fixture_path("mat10000"))


@pytest.fixture()
def rng():
    # function-scoped: every test gets the same deterministic stream,
    # independent of execution order
    return np.random.default_rng(42)


@pytest.fixture()
def gpu():
    """Skip unless JAX runs on a GPU (tests marked ``gpu``); decided when
    the test runs, never at import."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
