"""CSR->CSC transpose driver (reference: drivers/csrcsc.cpp).

Mirrors the reference's temporary compute-pool bump around the call
(csrcsc.cpp:58-61: grow to 8 threads, restore after) — the transpose's
per-block work is host-heavy, so it profits from extra compute threads
that the streaming kernels don't need.

    python -m bof_tpu_torch.drivers.csrcsc A_prefix m k OUT_prefix
"""
from __future__ import annotations

import numpy as np

from ..core.flash_array import map_array
from ..sparse import CsrFlashMatrix, csrcsc
from ._common import Timed, base_parser, make_context


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("a_prefix")
    p.add_argument("m", type=int)
    p.add_argument("k", type=int)
    p.add_argument("out_prefix")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="value dtype of A.csr and OUT.csr (the transpose "
                        "is a pure permutation — exact at any dtype)")
    args = p.parse_args(argv)
    ctx = make_context(args)
    m, k = args.m, args.k
    dt = np.dtype(args.dtype)
    A = CsrFlashMatrix.map_files(args.a_prefix, (m, k), val_dtype=dt,
                                 ctx=ctx)
    ia = map_array(args.out_prefix + ".off", (k + 1,), np.int64,
                   create=True, ctx=ctx)
    ja = map_array(args.out_prefix + ".col", (A.nnz,), A.ja.dtype,
                   create=True, ctx=ctx)
    vals = map_array(args.out_prefix + ".csr", (A.nnz,), dt,
                     create=True, ctx=ctx)
    out = CsrFlashMatrix(ia, ja, vals, (k, m))
    sched = ctx.scheduler()
    prev_threads = sched._n_compute
    sched.set_num_compute_threads(max(prev_threads, 8))
    try:
        with Timed("csrcsc", nbytes=2.0 * A.nnz * (8.0 + dt.itemsize)):
            csrcsc(A, out, ctx=ctx)
    finally:
        sched.set_num_compute_threads(prev_threads)  # shrink via pills
    print(f"nnz {out.nnz}")
    ctx.destroy()


if __name__ == "__main__":
    main()
