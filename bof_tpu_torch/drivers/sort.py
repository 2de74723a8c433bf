"""External sort driver (reference: drivers/sort.cpp; --in-mem gives the
in_mem_sort baseline, drivers/in_mem_sort.cpp).

    python -m bof_tpu_torch.drivers.sort in.bin out.bin n [--dtype f4] [--desc]
        [--device cuda]

The block sorter is FlashConfig.sort_compute's ('host' by default; a
caller that sets 'device' on the context gets kernel B10 on --device).
"""
from __future__ import annotations

import numpy as np

from ..core.flash_array import map_array
from ..ops.sort import bof_sort
from ._common import Timed, base_parser, make_context


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("in_path")
    p.add_argument("out_path")
    p.add_argument("n", type=int)
    p.add_argument("--dtype", default="f4")
    p.add_argument("--desc", action="store_true")
    p.add_argument("--blk", type=int, default=None)
    p.add_argument("--in-mem", action="store_true",
                   help="np.sort baseline with the file fully resident")
    args = p.parse_args(argv)
    dt = np.dtype(args.dtype)
    if args.in_mem:
        x = np.fromfile(args.in_path, dt, count=args.n)
        with Timed("in_mem_sort", nbytes=2.0 * x.nbytes):
            x.sort()
            if args.desc:
                x = x[::-1]
        x.tofile(args.out_path)
        return
    ctx = make_context(args)
    src = map_array(args.in_path, (args.n,), dt, ctx=ctx)
    dst = map_array(args.out_path, (args.n,), dt, create=True, ctx=ctx)
    with Timed("sort", nbytes=4.0 * args.n * dt.itemsize):
        bof_sort(src, dst, descending=args.desc, blk_elems=args.blk, ctx=ctx)
    ctx.destroy()


if __name__ == "__main__":
    main()
