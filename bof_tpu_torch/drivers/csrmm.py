"""Out-of-core CSRMM driver (reference: drivers/csrmm.cpp).

    python -m bof_tpu_torch.drivers.csrmm A_prefix m k B.bin n C.bin \
        [--ta N|T] [--order-b R|C] [--alpha] [--beta] [--pmem] \
        [--device cuda|cpu]

A_prefix expands to A_prefix.off/.col/.csr (the reference's file triplet).
--pmem keeps B/C in DRAM (reference: drivers/csrmm_pmem.cpp).
"""
from __future__ import annotations

import numpy as np

from ..core.flash_array import map_array, mem_array
from ..sparse import CsrFlashMatrix, csrmm
from ._common import Timed, base_parser, checksum, make_context


def main(argv=None) -> float:
    """Runs one csrmm; returns its wall seconds (printed to stderr too)."""
    p = base_parser(__doc__)
    p.add_argument("a_prefix")
    p.add_argument("m", type=int)
    p.add_argument("k", type=int)
    p.add_argument("b_path")
    p.add_argument("n", type=int)
    p.add_argument("c_path")
    p.add_argument("--ta", default="N", choices="NT")
    p.add_argument("--order-b", default="R", choices="RC")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--pmem", action="store_true",
                   help="B/C in DRAM (csrmm_pmem)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="value dtype of A.csr/B/C (FP_DOUBLE_PRECISION "
                        "parity: fp64 runs the exact host block products)")
    p.add_argument("--create-c", action="store_true")
    p.add_argument("--sharded", action="store_true",
                   help="row-shard the block products over every rank "
                        "('N' only): torchrun --nproc-per-node N for N "
                        "cards, one rank without torchrun")
    args = p.parse_args(argv)
    if args.sharded and args.ta == "T":
        p.error("--sharded supports transa='N' only")
    if args.sharded and args.dtype == "float64":
        p.error("--sharded is device-only and cannot represent float64 "
                "exactly; use the single-host path")
    if args.sharded and args.pmem:
        p.error("--sharded writes each rank's C rows into C's file; --pmem "
                "keeps C in one process's memory")
    ctx = make_context(args)
    try:
        m, k, n = args.m, args.k, args.n
        dt = np.dtype(args.dtype)
        A = CsrFlashMatrix.map_files(args.a_prefix, (m, k), val_dtype=dt,
                                     ctx=ctx)
        c_rows = k if args.ta == "T" else m
        b_rows = m if args.ta == "T" else k
        if args.pmem:
            raw = np.fromfile(args.b_path, dt)
            # honor --order-b: a column-major file's bytes are the
            # transpose of the row-major reshape
            b_np = (raw.reshape(n, b_rows).T if args.order_b == "C"
                    else raw.reshape(b_rows, n))
            B = mem_array((b_rows, n), dt, args.order_b, data=b_np,
                          ctx=ctx)
            C = mem_array((c_rows, n), dt, args.order_b, ctx=ctx)
        else:
            B = map_array(args.b_path, (b_rows, n), dt, args.order_b,
                          ctx=ctx)
            C = map_array(args.c_path, (c_rows, n), dt, args.order_b,
                          create=args.create_c, ctx=ctx)
        nnz_bytes = A.ja.dtype.itemsize + A.vals.dtype.itemsize
        with Timed("csrmm", flops=2.0 * A.nnz * n,
                   nbytes=(A.nnz * float(nnz_bytes)
                           + (b_rows + c_rows) * n * float(dt.itemsize))) \
                as t:
            if args.sharded:
                from ..parallel import csrmm_sharded, make_mesh
                csrmm_sharded(A, B, C, alpha=args.alpha, beta=args.beta,
                              mesh=make_mesh(device=args.device), ctx=ctx)
            else:
                csrmm(A, B, C, alpha=args.alpha, beta=args.beta,
                      transa=args.ta, ctx=ctx)
        if args.pmem:
            out = C.read_all()
            if args.order_b == "C":  # file layout follows --order-b
                out = np.ascontiguousarray(out.T)
            out.tofile(args.c_path)
        print(f"checksum {checksum(C.read_block(0, min(c_rows, 128)))}")
    finally:
        ctx.destroy()
    return t.seconds


if __name__ == "__main__":
    main()
