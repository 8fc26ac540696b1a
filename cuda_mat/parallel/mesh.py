"""Device mesh construction and multi-host initialization.

The reference selects one GPU at CLI start (``findCudaDevice``, reference
example.cpp:237 → helper_cuda.h:1244) and each solver call owns the device.
Here it is a one-time process-group init + a named mesh; solver
calls are pure functions over sharded arrays (SURVEY §3.5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


ROWS_AXIS = "rows"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host process-group init (``jax.distributed.initialize``).

    No-op on a single host with no coordinator configured; on a pod slice the
    explicit args wire up the process group.  This replaces nothing
    in the reference — it has no multi-host path — and is the entry point the
    10M-row N-host config uses.
    """
    if coordinator_address is None and num_processes is None:
        # single-process: nothing to do (jax.distributed would error)
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis: str = ROWS_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all).

    Row partitioning of the matrix is the single meaningful scaling axis for
    an Ax=b solver (SURVEY §2), so the mesh is one-dimensional; the axis name
    is what ``psum``/``ppermute`` reduce/shift over.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))
