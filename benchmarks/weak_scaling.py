"""Weak-scaling harness: distributed SpMV + BiCGSTAB at fixed rows/device.

BASELINE.json north star: >= 80% weak-scaling efficiency 1 -> N (rows grow
with devices; per-device work constant; the only growth is the w-element
halo ppermute + the psum latency).

On the GPUs of one host:

    python benchmarks/weak_scaling.py --platform gpu --devices 1 2 4 \
        --rows-per-dev 1000000 --engine stencil

and efficiency = t(1 dev) / t(N dev) for fixed rows/device.  On the forced
virtual CPU mesh (``--platform cpu`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=N``) it validates the code
path and the efficiency accounting only; those times are not device
numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--rows-per-dev", type=int, default=250_000)
    p.add_argument("--bandwidth", type=int, default=1000,
                   help="halo width of the generated banded system")
    p.add_argument("--iters", type=int, default=50,
                   help="chained SpMV applications per timing")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--platform", choices=["gpu", "cpu"], default=None,
                   help="run on this JAX platform (cpu: with the XLA_FLAGS"
                        " virtual device count)")
    p.add_argument("--solve", action="store_true",
                   help="also time a fixed-iteration distributed solve")
    p.add_argument("--engine", choices=["xla", "stencil"],
                   default="xla",
                   help="per-shard SpMV engine; 'stencil' generates a 2-D"
                        " grid Laplacian (row length = --grid-cols) and runs"
                        " the gap-strided matrix-free stencil")
    p.add_argument("--grid-cols", type=int, default=100)
    args = p.parse_args(argv)

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from cuda_mat.formats.dia import DIAMatrix
    from cuda_mat.ops.selection import check_platform
    from cuda_mat.parallel.mesh import make_mesh
    from cuda_mat.parallel.partition import (RowPartitionedBanded,
                                             RowPartitionedStencil)
    from cuda_mat.parallel.dist_solver import make_dist_spmv
    from cuda_mat.utils.compile_cache import enable_compile_cache

    platform = check_platform()
    if args.platform and platform != args.platform:
        raise SystemExit(f"platform {args.platform} requested, but JAX runs"
                         f" on {platform}")
    enable_compile_cache()
    dev = jax.devices()[0]

    navail = len(jax.devices())
    results = []
    base_t = None
    for ndev in args.devices:
        if ndev > navail:
            print(f"skip ndev={ndev}: only {navail} devices", file=sys.stderr)
            continue
        n = args.rows_per_dev * ndev
        w = args.bandwidth if args.engine != "stencil" else args.grid_cols
        # banded Laplacian-like system: diag 4, off-diagonals -1 at +-1, +-w
        offsets = (-w, -1, 0, 1, w)
        data = np.zeros((5, n), dtype=np.float32)
        data[2] = 4.0
        for k, off in enumerate(offsets):
            if off == 0:
                continue
            lo, hi = max(0, -off), min(n, n - off)
            data[k, lo:hi] = -1.0
        if args.engine == "stencil":
            # true 2-D grid Laplacian (boundary zeros on the +-1 seams) so
            # detection proves the constant-stencil structure
            c = args.grid_cols
            assert n % c == 0, "rows_per_dev*ndev must be divisible by --grid-cols"
            col = np.arange(n) % c
            data[1, col == 0] = 0.0
            data[3, col == c - 1] = 0.0
        dia = DIAMatrix(n, n, np.asarray(offsets, dtype=np.int32), data,
                        int(np.count_nonzero(data)))
        mesh = make_mesh(ndev)
        if args.engine == "stencil":
            part = RowPartitionedStencil.from_matrix(dia, ndev)
        else:
            part = RowPartitionedBanded.from_matrix(dia, ndev)
        fn, put = make_dist_spmv(part, mesh, dtype=jnp.dtype(args.dtype),
                                 local_engine=args.engine)
        x = put(np.ones(n))
        # chained applications; scale keeps iterates bounded
        @jax.jit
        def chain(x):
            return jax.lax.fori_loop(
                0, args.iters, lambda i, v: fn(v) * 0.1, x)

        jax.block_until_ready(chain(x))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(chain(x))
            ts.append(time.perf_counter() - t0)
        t = min(ts) / args.iters
        if base_t is None:
            base_t = t
        eff = base_t / t
        gbps = (7 * n * 4) / t / 1e9  # operand-once model, whole problem
        results.append(dict(ndev=ndev, n=n, t_spmv_us=round(t * 1e6, 1),
                            agg_gbps=round(gbps, 1),
                            weak_efficiency=round(eff, 3)))
        print(json.dumps(results[-1]), file=sys.stderr, flush=True)

    print(json.dumps({"metric": "weak_scaling_efficiency",
                      "value": results[-1]["weak_efficiency"] if results else 0,
                      "unit": "t1/tN @ fixed rows/dev",
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())},
                      "configs": results}))


if __name__ == "__main__":
    main()
