"""CSR gemv driver (reference: drivers/csrgemv.cpp).

    python -m bof_tpu_torch.drivers.csrgemv A_prefix m k x.bin y.bin \
        [--trans N|T] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np

from ..sparse import CsrFlashMatrix, csrgemv
from ._common import Timed, base_parser, checksum, make_context


def main(argv=None) -> float:
    """Runs one csrgemv; returns its wall seconds (printed to stderr too)."""
    p = base_parser(__doc__)
    p.add_argument("a_prefix")
    p.add_argument("m", type=int)
    p.add_argument("k", type=int)
    p.add_argument("x_path")
    p.add_argument("y_path")
    p.add_argument("--trans", default="N", choices="NT")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="value dtype of A.csr/x/y (FP_DOUBLE_PRECISION "
                        "parity: fp64 routes to the exact host path)")
    args = p.parse_args(argv)
    ctx = make_context(args)
    try:
        dt = np.dtype(args.dtype)
        A = CsrFlashMatrix.map_files(args.a_prefix, (args.m, args.k),
                                     val_dtype=dt, ctx=ctx)
        xlen = args.m if args.trans == "T" else args.k
        x = np.fromfile(args.x_path, dt, count=xlen)
        nnz_bytes = A.ja.dtype.itemsize + A.vals.dtype.itemsize
        with Timed("csrgemv", flops=2.0 * A.nnz,
                   nbytes=A.nnz * float(nnz_bytes)) as t:
            y = csrgemv(A, x, trans=args.trans, ctx=ctx)
        y.tofile(args.y_path)
        print(f"checksum {checksum(y)}")
    finally:
        ctx.destroy()
    return t.seconds


if __name__ == "__main__":
    main()
