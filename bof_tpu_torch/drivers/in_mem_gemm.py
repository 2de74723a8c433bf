"""In-memory GEMM baseline driver (reference: drivers/in_mem_gemm.cpp —
the MKL twin used for A/B comparison; here one torch matmul on the
device with the operands fully resident, `ops/gemm.py:gemm_in_mem`).

    python -m bof_tpu_torch.drivers.in_mem_gemm A.bin B.bin C.bin m n k \
        [--ta N|T] [--tb N|T] [--order R|C] [--alpha 1] [--beta 0] \
        [--dtype float32|float64] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np

from ..ops.gemm import gemm_in_mem
from ._common import Timed, base_parser, checksum


def main(argv=None) -> float:
    """Runs the in-memory gemm; returns its wall seconds (printed too)."""
    p = base_parser(__doc__)
    p.add_argument("a_path")
    p.add_argument("b_path")
    p.add_argument("c_path")
    p.add_argument("m", type=int)
    p.add_argument("n", type=int)
    p.add_argument("k", type=int)
    p.add_argument("--ta", default="N", choices="NT")
    p.add_argument("--tb", default="N", choices="NT")
    p.add_argument("--order", default="R", choices="RC")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="float64 = a float64 matmul on the device "
                        "(in_mem_gemm.cpp double build)")
    args = p.parse_args(argv)
    m, n, k = args.m, args.n, args.k
    dt = np.dtype(args.dtype)
    a_shape = (k, m) if args.ta == "T" else (m, k)
    b_shape = (n, k) if args.tb == "T" else (k, n)

    def load(path, shape):
        x = np.fromfile(path, dtype=dt, count=shape[0] * shape[1])
        x = x.reshape(shape if args.order == "R" else shape[::-1])
        return x if args.order == "R" else x.T

    a_np = load(args.a_path, a_shape)
    b_np = load(args.b_path, b_shape)
    c_np = load(args.c_path, (m, n)) if args.beta != 0.0 else None

    def run():
        return gemm_in_mem(a_np, b_np, c_np, args.alpha, args.beta,
                           args.ta, args.tb, prec=args.precision,
                           device=args.device)
    run()  # warm-up at the full shape (first-call costs kept out)
    with Timed("in_mem_gemm", flops=2.0 * m * n * k) as t:
        out = run()
    store = out if args.order == "R" else np.ascontiguousarray(out.T)
    store.tofile(args.c_path)
    print(f"checksum {checksum(out[:128, :128])}")
    return t.seconds


if __name__ == "__main__":
    main()
