"""Native (C++) runtime components, loaded via ctypes.

The reference's host-side runtime is C/C++ (Matrix Market parsing in mmio.c,
CSR conversion in mmio_wrapper.h, ILU setup orchestration in pbicgstab.cu).
This framework keeps the same split: JAX/XLA own the device compute path, while the ingestion/setup hot spots have C++ implementations here
(built with ``make -C cuda_mat/native``), with pure-Python fallbacks so
the framework works unbuilt.
"""
