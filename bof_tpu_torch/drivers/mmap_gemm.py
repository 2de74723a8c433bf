"""OS-paging GEMM baseline (reference: drivers/mmap_gemm.cpp — the paper's
"let the OS page it" strawman): operands are np.memmap'ed and blocks are
pulled through page faults instead of explicit I/O.  float32 blocks
multiply on the device (a plain torch.matmul: bof_tpu leaves this product
to XLA, outside any Pallas kernel); float64 pages blocks through host
dgemm, as bof_tpu does.

    python -m bof_tpu_torch.drivers.mmap_gemm A.bin B.bin C.bin m n k \
        [--blk 8192] [--dtype float32|float64] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np

from ._common import Timed, base_parser, checksum


def main(argv=None) -> float:
    """Runs the paged gemm; returns its wall seconds (printed too)."""
    p = base_parser(__doc__)
    p.add_argument("a_path")
    p.add_argument("b_path")
    p.add_argument("c_path")
    p.add_argument("m", type=int)
    p.add_argument("n", type=int)
    p.add_argument("k", type=int)
    p.add_argument("--blk", type=int, default=8192)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="float64 pages blocks through host dgemm")
    args = p.parse_args(argv)
    m, n, k, sb = args.m, args.n, args.k, args.blk
    dt = np.dtype(args.dtype)
    host = dt == np.float64
    if not host:
        from ..ops import device as dev
        device = dev.resolve_device(args.device)
    a = np.memmap(args.a_path, dt, "r", shape=(m, k))
    b = np.memmap(args.b_path, dt, "r", shape=(k, n))
    c = np.memmap(args.c_path, dt, "r+", shape=(m, n))
    with Timed("mmap_gemm", flops=2.0 * m * n * k) as t:
        for i0 in range(0, m, sb):
            i1 = min(i0 + sb, m)
            for j0 in range(0, n, sb):
                j1 = min(j0 + sb, n)
                acc = None
                for l0 in range(0, k, sb):
                    l1 = min(l0 + sb, k)
                    if host:
                        part = np.asarray(a[i0:i1, l0:l1]) \
                            @ np.asarray(b[l0:l1, j0:j1])
                    else:
                        part = dev.to_device(a[i0:i1, l0:l1], device) \
                            @ dev.to_device(b[l0:l1, j0:j1], device)
                    acc = part if acc is None else acc + part
                c[i0:i1, j0:j1] = acc if host else dev.from_device(acc)
        c.flush()
    print(f"checksum {checksum(np.asarray(c[:128, :128]))}")
    return t.seconds


if __name__ == "__main__":
    main()
