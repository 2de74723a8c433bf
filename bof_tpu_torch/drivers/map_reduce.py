"""map+reduce driver: map=sqrt then reduce=sum (reference:
drivers/map_reduce.cpp does exactly this composition).

    python -m bof_tpu_torch.drivers.map_reduce in.bin out.bin n
        [--dtype float32|float64] [--device cuda]

float32 maps torch.sqrt on --device; float64 maps np.sqrt on the host.
"""
from __future__ import annotations

import numpy as np

from ..core.flash_array import map_array
from ..ops.map_reduce import bof_map, bof_reduce
from ._common import Timed, base_parser, make_context


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("in_path")
    p.add_argument("out_path")
    p.add_argument("n", type=int)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="element dtype (the reference's map/reduce are "
                        "templated on T, map_reduce.tpp); float64 blocks "
                        "run the exact numpy ufunc on the host")
    args = p.parse_args(argv)
    ctx = make_context(args)
    dt = np.dtype(args.dtype)
    if dt == np.float64:
        fn = np.sqrt  # exact host path (ops/map_reduce.py 64-bit guard)
    else:
        import torch
        fn = torch.sqrt
    src = map_array(args.in_path, (args.n,), dt, ctx=ctx)
    dst = map_array(args.out_path, (args.n,), dt, create=True,
                    ctx=ctx)
    with Timed("map(sqrt)", nbytes=2.0 * dt.itemsize * args.n):
        bof_map(src, dst, fn, ctx=ctx)
    with Timed("reduce(sum)", nbytes=float(dt.itemsize) * args.n):
        total = bof_reduce(dst, "sum", ctx=ctx)
    print(f"sum {total}")
    ctx.destroy()
    return total


if __name__ == "__main__":
    main()
