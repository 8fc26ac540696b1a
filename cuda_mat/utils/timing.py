"""Phase timing with device-completion semantics.

The reference's only profiling primitive is a wall-clock ``second()`` helper
(reference helper_cusolver.h:124-169) wrapped around phases, with a
``cudaDeviceSynchronize`` before the stop reading (reference
pbicgstab.cu:372-374).  Here ``perf_counter`` wraps
``jax.block_until_ready`` so async dispatch can't leak out of the phase.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


def second() -> float:
    """Wall clock in seconds (name kept from reference helper_cusolver.h:124)."""
    return time.perf_counter()


class PhaseTimer:
    """Named phase timers: load / setup / solve, matching the reference's
    printed phase split (analysis+ilu at pbicgstab.cu:335-363, dtAlg at
    :365-374, total at example.cpp:351-365)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[object] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "\n".join(f"{k}: {v:.6f} s" for k, v in self.times.items())
