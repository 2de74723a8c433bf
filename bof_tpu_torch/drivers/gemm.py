"""Out-of-core GEMM driver (reference: drivers/gemm.cpp).

    python -m bof_tpu_torch.drivers.gemm A.bin B.bin C.bin m n k \
        [--ta N|T] [--tb N|T] [--order R|C] [--alpha 1] [--beta 0] \
        [--blk 8192] [--device cuda|cpu] [--sharded]

With --sharded every superblock is sharded over the ranks of a mesh
(parallel.gemm_sharded): `torchrun --nproc-per-node N -m
bof_tpu_torch.drivers.gemm ... --sharded` for N cards, one rank without
torchrun.
"""
from __future__ import annotations

import numpy as np

from ..core.flash_array import map_array
from ..ops.gemm import gemm
from ._common import Timed, base_parser, checksum, make_context


def main(argv=None) -> float:
    """Runs one gemm; returns its wall seconds (printed to stderr too)."""
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
    p.add_argument("--blk", type=int, default=None)
    p.add_argument("--tile", type=int, default=None,
                   help="operands are tile-major files with this tile edge; "
                        "implies blk=tile so every superblock read is one "
                        "contiguous run")
    p.add_argument("--lda", type=int, default=None,
                   help="leading dimension of A's file (elements per "
                        "storage line; reference drivers/gemm.cpp lda_a)")
    p.add_argument("--ldb", type=int, default=None)
    p.add_argument("--ldc", type=int, default=None)
    p.add_argument("--create-c", action="store_true")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="float64 runs K1's 'f64' variant (DMMA) on the "
                        "card (FP_DOUBLE_PRECISION parity)")
    p.add_argument("--sharded", action="store_true",
                   help="shard every superblock over the ranks of a mesh "
                        "(torch.distributed reduce-scatter; torchrun for "
                        "several cards)")
    p.add_argument("--resume-journal", default=None,
                   help="journal file for superblock-granular "
                        "kill-and-resume; requires beta=0; removed on "
                        "completion")
    args = p.parse_args(argv)
    if args.resume_journal and args.sharded:
        # argument validation must precede map_array: --create-c would
        # otherwise create/truncate the C file before the usage error
        p.error("--resume-journal applies to the single-card path")
    ctx = make_context(args)
    m, n, k = args.m, args.n, args.k
    dt = np.dtype(args.dtype)
    a_shape = (k, m) if args.ta == "T" else (m, k)
    b_shape = (n, k) if args.tb == "T" else (k, n)
    try:
        if args.tile:
            from ..core.tiled_array import map_tiled_array
            if args.lda or args.ldb or args.ldc:
                p.error("--lda/--ldb/--ldc apply to flat layouts, not "
                        "--tile")
            args.blk = args.tile
            A = map_tiled_array(args.a_path, a_shape, dt, args.order,
                                tile=args.tile, ctx=ctx)
            B = map_tiled_array(args.b_path, b_shape, dt, args.order,
                                tile=args.tile, ctx=ctx)
            C = map_tiled_array(args.c_path, (m, n), dt, args.order,
                                tile=args.tile, create=args.create_c,
                                ctx=ctx)
        else:
            A = map_array(args.a_path, a_shape, dt, args.order, ctx=ctx,
                          ld=args.lda)
            B = map_array(args.b_path, b_shape, dt, args.order, ctx=ctx,
                          ld=args.ldb)
            C = map_array(args.c_path, (m, n), dt, args.order,
                          create=args.create_c, ctx=ctx, ld=args.ldc)
        with Timed("gemm", flops=2.0 * m * n * k) as t:
            if args.sharded:
                from ..parallel import gemm_sharded, make_mesh
                gemm_sharded(A, B, C, alpha=args.alpha, beta=args.beta,
                             transa=args.ta, transb=args.tb, blk=args.blk,
                             mesh=make_mesh(device=args.device), ctx=ctx)
            else:
                gemm(A, B, C, alpha=args.alpha, beta=args.beta,
                     transa=args.ta, transb=args.tb, blk=args.blk, ctx=ctx,
                     resume_journal=args.resume_journal)
        print(f"checksum "
              f"{checksum(C.read_block(0, min(m, 128), 0, min(n, 128)))}")
    finally:
        ctx.destroy()
    return t.seconds


if __name__ == "__main__":
    main()
