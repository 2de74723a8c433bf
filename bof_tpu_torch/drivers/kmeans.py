"""k-means driver (reference: drivers/kmeans.cpp — full Lloyd's loop over
flash-resident points; --in-mem gives the in_mem_kmeans baseline).

    python -m bof_tpu_torch.drivers.kmeans points.bin n d k [--iters 10] \
        [--seed 0] [--labels-out L.bin] [--state S.npz] [--in-mem] \
        [--dtype float32|float64] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np

from ..core.flash_array import map_array
from ..ops.kmeans import kmeans_fit, kmeans_in_mem
from ._common import Timed, base_parser, make_context


def main(argv=None):
    """Runs one fit; returns (centers, inertia) (the inertia is printed)."""
    p = base_parser(__doc__)
    p.add_argument("points_path")
    p.add_argument("n", type=int)
    p.add_argument("d", type=int)
    p.add_argument("k", type=int)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--labels-out", default=None)
    p.add_argument("--in-mem", action="store_true")
    p.add_argument("--sharded", action="store_true",
                   help="data-parallel Lloyd over every rank: torchrun "
                        "--nproc-per-node N for N cards, one rank without "
                        "torchrun")
    p.add_argument("--state", default=None,
                   help="checkpoint file: interrupted fits resume from "
                        "the last completed iteration")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="point dtype (FP_DOUBLE_PRECISION parity: fp64 "
                        "runs the exact host Lloyd step, ops/kmeans.py)")
    args = p.parse_args(argv)
    n, d, k = args.n, args.d, args.k
    dt = np.dtype(args.dtype)
    if args.sharded and args.dtype == "float64":
        p.error("--sharded is device-only and cannot represent float64 "
                "exactly; use the single-host path")
    if args.in_mem:
        pts = np.fromfile(args.points_path, dt, count=n * d).reshape(n, d)
        rng = np.random.default_rng(args.seed)
        c0 = pts[np.sort(rng.choice(n, k, replace=False))]
        with Timed("in_mem_kmeans", flops=2.0 * n * d * k * args.iters):
            centers, inertia = kmeans_in_mem(pts, c0, n_iters=args.iters)
        print(f"inertia {inertia}")
        return centers, inertia
    ctx = make_context(args)
    try:
        P = map_array(args.points_path, (n, d), dt, ctx=ctx)
        labels = None
        if args.labels_out:
            labels = map_array(args.labels_out, (n,), np.int32, create=True,
                               ctx=ctx)
        with Timed("kmeans", flops=2.0 * n * d * k * args.iters):
            if args.sharded:
                from ..parallel import kmeans_fit_sharded, make_mesh
                centers, inertia = kmeans_fit_sharded(
                    P, k, n_iters=args.iters, seed=args.seed,
                    labels_out=labels, mesh=make_mesh(device=args.device),
                    ctx=ctx)
            else:
                centers, inertia = kmeans_fit(
                    P, k, n_iters=args.iters, seed=args.seed,
                    labels_out=labels, state_path=args.state, ctx=ctx)
        print(f"inertia {inertia}")
    finally:
        ctx.destroy()
    return centers, inertia


if __name__ == "__main__":
    main()
