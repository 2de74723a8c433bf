"""GEMM correctness harness across all 8 configs (reference:
misc/gemm_run.sh — generates random matrices, runs flash + in-memory
drivers for every {N,T}x{N,T}x{R,C} combination, compares by max relative
error).

    python -m bof_tpu_torch.drivers.gemm_run [--m 512 --n 384 --k 448] \
        [--blk 128] [--dtype float32|float64] [--ld-pad 0] [--device cuda|cpu]
"""
from __future__ import annotations

import itertools
import os
import tempfile

import numpy as np

from ..core.flash_array import map_array
from ..ops.gemm import gemm, gemm_in_mem
from ._common import base_parser, make_context


def main(argv=None) -> int:
    p = base_parser(__doc__)
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--n", type=int, default=384)
    p.add_argument("--k", type=int, default=448)
    p.add_argument("--blk", type=int, default=128)
    p.add_argument("--rtol", type=float, default=None,
                   help="max relative error (default 2e-4 fp32, 1e-12 "
                        "fp64)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="float64 sweeps the same 8 configs through K1's "
                        "'f64' variant against numpy float64")
    p.add_argument("--ld-pad", type=int, default=0,
                   help="extra elements of leading-dimension padding on "
                        "every operand file (exercises the reference's "
                        "lda support across all configs)")
    args = p.parse_args(argv)
    ctx = make_context(args)
    dt = np.dtype(args.dtype)
    rtol = args.rtol if args.rtol is not None else (
        2e-4 if dt == np.float32 else 1e-12)
    m, n, k = args.m, args.n, args.k
    rng = np.random.default_rng(7)
    worst = 0.0
    failures = 0
    try:
        with tempfile.TemporaryDirectory(dir=args.scratch) as td:
            for order, ta, tb in itertools.product("RC", "NT", "NT"):
                a_shape = (k, m) if ta == "T" else (m, k)
                b_shape = (n, k) if tb == "T" else (k, n)
                a_np = rng.standard_normal(a_shape).astype(dt)
                b_np = rng.standard_normal(b_shape).astype(dt)

                def _ld(shape):  # storage-line width + padding
                    w = shape[1] if order == "R" else shape[0]
                    return w + args.ld_pad if args.ld_pad else None

                A = map_array(os.path.join(td, "A"), a_shape, dt,
                              order, create=True, ctx=ctx, ld=_ld(a_shape))
                B = map_array(os.path.join(td, "B"), b_shape, dt,
                              order, create=True, ctx=ctx, ld=_ld(b_shape))
                C = map_array(os.path.join(td, "C"), (m, n), dt,
                              order, create=True, ctx=ctx, ld=_ld((m, n)))
                A.write_all(a_np)
                B.write_all(b_np)
                gemm(A, B, C, transa=ta, transb=tb, blk=args.blk, ctx=ctx)
                got = C.read_all()
                if dt == np.float64:  # exact host golden
                    want = ((a_np.T if ta == "T" else a_np)
                            @ (b_np.T if tb == "T" else b_np))
                else:
                    want = gemm_in_mem(a_np, b_np, transa=ta, transb=tb,
                                       prec=args.precision,
                                       device=args.device)
                denom = np.abs(want).max() or 1.0
                rel = float(np.abs(got - want).max() / denom)
                worst = max(worst, rel)
                status = "OK " if rel < rtol else "FAIL"
                if rel >= rtol:
                    failures += 1
                print(f"{status} order={order} ta={ta} tb={tb} "
                      f"max-rel-err={rel:.3e}")
                for arr in (A, B, C):
                    arr.store.close()
    finally:
        ctx.destroy()
    print(f"worst max-rel-err {worst:.3e} "
          f"({'ALL PASS' if failures == 0 else f'{failures} FAILURES'})")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
