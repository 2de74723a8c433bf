"""Flat <-> tile-major layout converter (extension beyond the reference:
its data files are always flat, misc/dense_create.cpp; the tile-major
twin makes every kernel superblock read one contiguous run, see
core/tiled_array.py).  Files are bof_tpu's, byte for byte.

    python -m bof_tpu_torch.drivers.repack flat.bin tiled.bin rows cols \
        --tile 8192 [--order R|C] [--unpack] [--verify]
"""
from __future__ import annotations

import numpy as np

from ..core.flash_array import map_array
from ..core.tiled_array import map_tiled_array, repack, unpack
from ._common import Timed, base_parser, checksum, make_context


def main(argv=None) -> int:
    p = base_parser(__doc__)
    p.add_argument("flat_path")
    p.add_argument("tiled_path")
    p.add_argument("rows", type=int)
    p.add_argument("cols", type=int)
    p.add_argument("--tile", type=int, default=8192,
                   help="tile edge; must equal the kernel blk the tiled "
                        "file will be used with")
    p.add_argument("--order", default="R", choices="RC")
    p.add_argument("--unpack", action="store_true",
                   help="convert tiled -> flat instead (creates flat_path)")
    p.add_argument("--verify", action="store_true",
                   help="re-read both files and compare checksums")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="element dtype (must match the flat file; the "
                        "tiled twin keeps it)")
    args = p.parse_args(argv)
    ctx = make_context(args)
    try:
        dt = np.dtype(args.dtype)
        shape = (args.rows, args.cols)
        nbytes = args.rows * args.cols * dt.itemsize
        if args.unpack:
            T = map_tiled_array(args.tiled_path, shape, dt, args.order,
                                tile=args.tile, ctx=ctx)
            F = map_array(args.flat_path, shape, dt, args.order,
                          create=True, ctx=ctx)
            with Timed("unpack", nbytes=nbytes):
                unpack(T, F)
        else:
            F = map_array(args.flat_path, shape, dt, args.order, ctx=ctx)
            T = map_tiled_array(args.tiled_path, shape, dt, args.order,
                                tile=args.tile, create=True, ctx=ctx)
            with Timed("repack", nbytes=nbytes):
                repack(F, T)
        if args.verify:
            r = min(args.rows, 4 * args.tile)
            c = min(args.cols, 4 * args.tile)
            cf = checksum(F.read_block(0, r, 0, c))
            ct = checksum(T.read_block(0, r, 0, c))
            ok = abs(cf - ct) <= 1e-6 * max(abs(cf), 1.0)
            print(f"verify window checksums flat={cf} tiled={ct} "
                  f"{'OK' if ok else 'MISMATCH'}")
            if not ok:
                return 1
    finally:
        ctx.destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
