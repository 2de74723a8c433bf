"""Out-of-core spectral solver driver (the paper's flagship application:
block eigensolver over bag-of-words CSR matrices, NSDI'19 §5 Table 4).

    python -m bof_tpu_torch.drivers.eigensolver A_prefix m k n_vals \
        [--iters 12] [--solver lanczos|power] [--state S.npz] \
        [--two-pass] [--device cuda|cpu]
"""
from __future__ import annotations

from ..apps import block_lanczos_svd, block_power_svd
from ..sparse import CsrFlashMatrix
from ._common import Timed, base_parser, make_context


def main(argv=None):
    """Runs one solve; returns (sigma, V) (sigma is printed)."""
    p = base_parser(__doc__)
    p.add_argument("a_prefix")
    p.add_argument("m", type=int)
    p.add_argument("k", type=int)
    p.add_argument("n_vals", type=int)
    p.add_argument("--iters", type=int, default=12,
                   help="power iterations / lanczos restarts")
    p.add_argument("--solver", choices=["lanczos", "power"],
                   default="lanczos",
                   help="lanczos = block Krylov with thick restart "
                        "(paper-parity, Table 4); power = block subspace "
                        "iteration baseline")
    p.add_argument("--state", default=None,
                   help="lanczos checkpoint file: interrupted runs resume "
                        "from the last completed restart cycle")
    p.add_argument("--sharded", action="store_true",
                   help="shard every operator application over every rank "
                        "(uses the csrmm composition): torchrun "
                        "--nproc-per-node N for N cards, one rank without "
                        "torchrun")
    p.add_argument("--two-pass", action="store_true",
                   help="apply A^T A as csrcsc + two csrmm passes (the "
                        "reference's 'T' dispatch structure) instead of "
                        "the default single streaming pass over A")
    args = p.parse_args(argv)
    ctx = make_context(args)
    try:
        A = CsrFlashMatrix.map_files(args.a_prefix, (args.m, args.k),
                                     ctx=ctx)
        with Timed("eigensolver",
                   flops=4.0 * A.nnz * args.n_vals * args.iters):
            mesh = None
            if args.sharded:
                from ..parallel import make_mesh
                mesh = make_mesh(device=args.device)
            one_pass = False if args.sharded else not args.two_pass
            if args.solver == "lanczos":
                sigma, v = block_lanczos_svd(A, args.n_vals,
                                             n_restarts=args.iters,
                                             state_path=args.state,
                                             one_pass=one_pass, mesh=mesh,
                                             ctx=ctx)
            else:
                sigma, v = block_power_svd(A, args.n_vals,
                                           n_iters=args.iters,
                                           one_pass=one_pass, ctx=ctx)
        print("singular values:", " ".join(f"{s:.6g}" for s in sigma))
    finally:
        ctx.destroy()
    return sigma, v


if __name__ == "__main__":
    main()
