"""Topic modeling driver (the paper's ISLE workload, NSDI'19 Table 5).

    python -m bof_tpu_torch.drivers.topic_model A_prefix docs vocab \
        n_topics [--proj-dim 64] [--iters 8] [--sample-rate 1.0] \
        [--state S.npz] [--out topics.bin] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np

from ..apps import topic_model
from ..sparse import CsrFlashMatrix
from ._common import Timed, base_parser, make_context


def main(argv=None):
    """Runs one model; returns (topic_word, labels)."""
    p = base_parser(__doc__)
    p.add_argument("a_prefix")
    p.add_argument("docs", type=int)
    p.add_argument("vocab", type=int)
    p.add_argument("n_topics", type=int)
    p.add_argument("--proj-dim", type=int, default=64)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--sample-rate", type=float, default=1.0,
                   help="cluster on a doc sample, assign the full corpus "
                        "in one pass (the paper's ISLE runs use 0.1)")
    p.add_argument("--state", default=None,
                   help="checkpoint file for the clustering stage")
    p.add_argument("--sharded", action="store_true",
                   help="projection + Lloyd steps over every rank: "
                        "torchrun --nproc-per-node N for N cards, one rank "
                        "without torchrun")
    p.add_argument("--out", default=None,
                   help="write (n_topics x vocab) fp32 topic-word matrix")
    args = p.parse_args(argv)
    ctx = make_context(args)
    try:
        A = CsrFlashMatrix.map_files(args.a_prefix, (args.docs, args.vocab),
                                     ctx=ctx)
        mesh = None
        if args.sharded:
            from ..parallel import make_mesh
            mesh = make_mesh(device=args.device)
        with Timed("topic_model", flops=2.0 * A.nnz * args.proj_dim
                   * (args.iters + 2)):
            tw, labels = topic_model(A, args.n_topics,
                                     proj_dim=args.proj_dim,
                                     n_iters=args.iters,
                                     sample_rate=args.sample_rate,
                                     state_path=args.state, mesh=mesh,
                                     ctx=ctx)
        print(f"topics {tw.shape} label-histogram "
              f"{np.bincount(labels, minlength=args.n_topics).tolist()}")
        # every rank holds the same result; one writes it
        if args.out and (mesh is None or mesh.get_rank() == 0):
            tw.tofile(args.out)
    finally:
        ctx.destroy()
    return tw, labels


if __name__ == "__main__":
    main()
