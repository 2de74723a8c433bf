"""Extreme multi-label ranking driver (the paper's XML inference
workload, NSDI'19 Table 6: PfastreXML/Parabel linear scoring over
bag-of-words features).

    python -m bof_tpu_torch.drivers.xml_rank A_prefix docs vocab W.bin \
        n_labels k [--scores scores.bin] [--labels labels.bin] \
        [--label-blk N] [--fused auto|on|off] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np

from ..apps import xml_rank
from ..core.flash_array import map_array
from ..sparse import CsrFlashMatrix
from ._common import Timed, base_parser, make_context


def main(argv=None):
    """Runs one ranking; returns (scores, labels) as (docs, k) arrays."""
    p = base_parser(__doc__)
    p.add_argument("a_prefix")
    p.add_argument("docs", type=int)
    p.add_argument("vocab", type=int)
    p.add_argument("w_path", help="(n_labels x vocab) fp32 row-major")
    p.add_argument("n_labels", type=int)
    p.add_argument("k", type=int)
    p.add_argument("--scores", default=None,
                   help="write (docs x k) fp32 top-k scores")
    p.add_argument("--labels", default=None,
                   help="write (docs x k) int32 top-k label ids")
    p.add_argument("--label-blk", type=int, default=None)
    p.add_argument("--sharded", action="store_true",
                   help="row-shard the scoring pass over every rank: "
                        "torchrun --nproc-per-node N for N cards, one rank "
                        "without torchrun")
    p.add_argument("--fused", choices=["auto", "on", "off"], default="auto",
                   help="fused device product + top-k path (auto: same "
                        "placement heuristic as csrmm)")
    args = p.parse_args(argv)
    ctx = make_context(args)
    try:
        A = CsrFlashMatrix.map_files(args.a_prefix, (args.docs, args.vocab),
                                     ctx=ctx)
        W = map_array(args.w_path, (args.n_labels, args.vocab), np.float32,
                      "R", ctx=ctx)
        s_out = (map_array(args.scores, (args.docs, args.k), np.float32,
                           "R", create=True, ctx=ctx)
                 if args.scores else None)
        l_out = (map_array(args.labels, (args.docs, args.k), np.int32, "R",
                           create=True, ctx=ctx)
                 if args.labels else None)
        fused = {"auto": None, "on": True, "off": False}[args.fused]
        mesh = None
        if args.sharded:
            from ..parallel import make_mesh
            mesh = make_mesh(device=args.device)
        with Timed("xml_rank", flops=2.0 * A.nnz * args.n_labels):
            s, l = xml_rank(A, W, args.k, scores_out=s_out, labels_out=l_out,
                            label_blk=args.label_blk, fused=fused, mesh=mesh,
                            ctx=ctx)
        s_np, l_np = s.read_all(), l.read_all()
        head = min(4, args.docs)
        print(f"top-{args.k} of {args.n_labels} labels for {args.docs} docs;"
              f" doc0..{head - 1} labels: {l_np[:head].tolist()} "
              f"checksum {float(s_np.sum()):.6g}")
    finally:
        ctx.destroy()
    return s_np, l_np


if __name__ == "__main__":
    main()
