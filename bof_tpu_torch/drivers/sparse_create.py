"""Random CSR generator writing the .off/.col/.csr triplet (reference:
misc/sparse_create.cpp, misc/README.md:8-12).

    python -m bof_tpu_torch.drivers.sparse_create prefix rows cols nnz_per_row
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("prefix")
    p.add_argument("rows", type=int)
    p.add_argument("cols", type=int)
    p.add_argument("nnz_per_row", type=float)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-rows", type=int, default=1 << 16)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="value dtype written to prefix.csr")
    args = p.parse_args(argv)
    val_dt = np.dtype(args.dtype)
    rng = np.random.default_rng(args.seed)
    lam = args.nnz_per_row
    off_f = open(args.prefix + ".off", "wb")
    col_f = open(args.prefix + ".col", "wb")
    val_f = open(args.prefix + ".csr", "wb")
    total = np.int64(0)
    off_f.write(np.int64(0).tobytes())
    done = 0
    while done < args.rows:
        r = min(args.chunk_rows, args.rows - done)
        counts = np.minimum(rng.poisson(lam, r), args.cols).astype(np.int64)
        total_chunk = int(counts.sum())
        # random sorted distinct-ish columns per row
        cols = rng.integers(0, args.cols, total_chunk, dtype=np.int64)
        row_ids = np.repeat(np.arange(r), counts)
        order = np.lexsort((cols, row_ids))
        cols = cols[order]
        vals = rng.standard_normal(total_chunk).astype(val_dt)
        offs = total + np.cumsum(counts)
        off_f.write(offs.tobytes())
        col_f.write(cols.tobytes())
        val_f.write(vals.tobytes())
        total = offs[-1] if len(offs) else total
        done += r
    for f in (off_f, col_f, val_f):
        f.close()
    print(f"wrote {args.rows}x{args.cols} CSR nnz={int(total)} "
          f"to {args.prefix}.off/.col/.csr")


if __name__ == "__main__":
    main()
