"""In-memory sparse baselines (reference: drivers/in_mem_csrmm.cpp,
in_mem_csrgemv.cpp, in_mem_csrcsc.cpp) — scipy with everything resident.

    python -m bof_tpu_torch.drivers.in_mem_sparse csrmm  A_prefix m k B.bin n C.bin
    python -m bof_tpu_torch.drivers.in_mem_sparse csrgemv A_prefix m k x.bin y.bin
    python -m bof_tpu_torch.drivers.in_mem_sparse csrcsc A_prefix m k OUT_prefix
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from ._common import Timed, base_parser, checksum


def load_csr(prefix: str, m: int, k: int,
             val_dtype=np.float32) -> sps.csr_matrix:
    ia = np.fromfile(prefix + ".off", np.int64, count=m + 1)
    nnz = int(ia[-1])
    ja = np.fromfile(prefix + ".col", np.int64, count=nnz)
    vals = np.fromfile(prefix + ".csr", val_dtype, count=nnz)
    return sps.csr_matrix((vals, ja, ia), shape=(m, k))


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("kernel", choices=["csrmm", "csrgemv", "csrcsc"])
    p.add_argument("a_prefix")
    p.add_argument("m", type=int)
    p.add_argument("k", type=int)
    p.add_argument("rest", nargs="*")
    p.add_argument("--trans", default="N", choices="NT")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="value dtype of the .csr file and dense operands")
    args = p.parse_args(argv)
    dt = np.dtype(args.dtype)
    a = load_csr(args.a_prefix, args.m, args.k, val_dtype=dt)
    if args.kernel == "csrmm":
        b_path, n, c_path = args.rest[0], int(args.rest[1]), args.rest[2]
        b_rows = args.k if args.trans == "N" else args.m
        b = np.fromfile(b_path, dt).reshape(b_rows, n)
        opa = a.T if args.trans == "T" else a
        with Timed("in_mem_csrmm", flops=2.0 * a.nnz * n):
            c = opa @ b
        np.asarray(c, dt).tofile(c_path)
        print(f"checksum {checksum(c[:128])}")
    elif args.kernel == "csrgemv":
        x_path, y_path = args.rest[0], args.rest[1]
        xlen = args.m if args.trans == "T" else args.k
        x = np.fromfile(x_path, dt, count=xlen)
        opa = a.T if args.trans == "T" else a
        with Timed("in_mem_csrgemv", flops=2.0 * a.nnz):
            y = np.asarray(opa @ x, dt)
        y.tofile(y_path)
        print(f"checksum {checksum(y)}")
    else:
        out_prefix = args.rest[0]
        with Timed("in_mem_csrcsc",
                   nbytes=2.0 * a.nnz * (8.0 + dt.itemsize)):
            at = sps.csr_matrix(a.T)
            at.sort_indices()
        at.indptr.astype(np.int64).tofile(out_prefix + ".off")
        at.indices.astype(np.int64).tofile(out_prefix + ".col")
        at.data.astype(dt).tofile(out_prefix + ".csr")
        print(f"nnz {at.nnz}")


if __name__ == "__main__":
    main()
