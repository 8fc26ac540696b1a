"""Distributed layer: device meshes, row-partitioned matrices, halo-exchange
SpMV, and multi-chip solver loops.

The reference is strictly single-GPU (SURVEY §2 parallelism table: no MPI/
NCCL/multi-device anywhere); this layer is the new-framework component the
BASELINE.json north star mandates: row-partitioned CSR/DIA across the
devices of a mesh, halo segments of x exchanged with ``ppermute``, dot products
reduced with ``psum``, the whole BiCGSTAB loop living inside one
``shard_map`` so per-iteration scalars are computed collectively on device.
"""

from cuda_mat.parallel.mesh import make_mesh, init_distributed
from cuda_mat.parallel.partition import (RowPartitionedBanded,
                                             RowPartitionedStencil)
from cuda_mat.parallel.dist_solver import (
    dist_bicgstab,
    dist_spmv,
    make_dist_bicgstab,
)

__all__ = [
    "make_mesh",
    "init_distributed",
    "RowPartitionedBanded",
    "RowPartitionedStencil",
    "dist_bicgstab",
    "dist_spmv",
    "make_dist_bicgstab",
]
