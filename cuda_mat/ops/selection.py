"""The one place that decides how a matrix runs on the device.

:func:`select_format` picks the single-chip operator format and, through the
same decision, the distributed per-shard engine (``"stencil"`` when the
matrix is a constant-coefficient grid stencil, else the XLA banded or
all-gather engine).  Every format is plain ``jnp``/``lax`` that XLA
compiles for either platform, so the choice follows structure alone.

:func:`check_platform`, called by every entry point that builds a device
operator, knows the platforms this program runs on — ``"gpu"`` and
``"cpu"`` (tests) — and refuses any other, so no path silently runs on
hardware it was not written for.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

PLATFORMS = ("gpu", "cpu")

# structure thresholds of the automatic choice
MAX_DIAGS = 16           # DIA: at most this many distinct diagonals ...
MIN_DIA_DENSITY = 0.4    # ... each on average this full
MAX_ELL_EXPAND = 4.0     # ELL: padded rows at most this many times nnz


def check_platform(platform: Optional[str] = None) -> str:
    """The JAX platform (default: the current backend), which must be one
    this program supports."""
    if platform is None:
        platform = jax.default_backend()
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: this program runs on"
            f" {' or '.join(PLATFORMS)}")
    return platform


def select_format(csr, format: Optional[str] = None):
    """Choose how the square or rectangular CSR matrix ``csr`` runs.

    Returns ``(format, dia)``: ``format`` is ``"stencil"`` (matrix-free
    constant grid stencil, :mod:`cuda_mat.ops.stencil`), ``"dia"``,
    ``"ell"`` or ``"csr"``, or ``format`` itself when the caller forces one;
    ``dia`` is the matrix's DIA form when it was built (banded matrices),
    else None.  ``format="stencil"`` raises ValueError on a matrix that is
    not a constant stencil.  The choice follows structure alone: the entry
    points that build device operators call :func:`check_platform`.
    """
    if format not in (None, "stencil"):
        return format, None
    from cuda_mat.ops.stencil import detect_const_stencil

    dia = None
    coo = csr.to_coo()
    offs = np.unique(coo.cols.astype(np.int64) - coo.rows.astype(np.int64))
    if 0 < offs.shape[0] <= MAX_DIAGS \
            and csr.nnz >= MIN_DIA_DENSITY * offs.shape[0] * csr.n:
        dia = csr.to_dia(max_diags=MAX_DIAGS)
        if csr.n == csr.m and detect_const_stencil(dia) is not None:
            return "stencil", dia
    if format == "stencil":
        raise ValueError("matrix is not a constant-coefficient grid"
                         " stencil; drop format='stencil'")
    if dia is not None:
        return "dia", dia
    max_row = int(csr.row_lengths.max()) if csr.n else 1
    if csr.n and max_row * csr.n <= MAX_ELL_EXPAND * max(csr.nnz, 1):
        return "ell", None
    return "csr", None
