"""Host-side sparse matrix containers (numpy) and conversions.

The reference works exclusively with raw CSR triplets ``(A, iA, jA)`` in
base-0 or base-1 indexing (reference pbicgstab.h:96-110).  Here each format is
a small dataclass; all indices are normalized to base 0 at construction.
Formats:

- :class:`COOMatrix` — load-time format (Matrix Market is COO on disk)
- :class:`CSRMatrix` — the canonical compute format (reference's only format)
- :class:`ELLMatrix` — row-padded layout: one rectangular gather per SpMV
- :class:`DIAMatrix` — diagonal (banded) layout, the no-gather SpMV path
- :class:`BSRMatrix` — block CSR (north-star "COO/BSR variants")
"""

from cuda_mat.formats.coo import COOMatrix
from cuda_mat.formats.csr import CSRMatrix, verify_pattern
from cuda_mat.formats.ell import ELLMatrix
from cuda_mat.formats.dia import DIAMatrix
from cuda_mat.formats.bsr import BSRMatrix

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "ELLMatrix",
    "DIAMatrix",
    "BSRMatrix",
    "verify_pattern",
]
