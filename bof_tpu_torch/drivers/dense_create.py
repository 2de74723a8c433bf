"""Dense matrix file generator (reference: misc/dense_create.cpp —
random/sequential/zero fills, documented misc/README.md:3-7).

    python -m bof_tpu_torch.drivers.dense_create out.bin rows cols \
        [--fill random|sequential|zero] [--seed 0] [--dtype float32|float64]
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_path")
    p.add_argument("rows", type=int)
    p.add_argument("cols", type=int)
    p.add_argument("--fill", default="random",
                   choices=["random", "sequential", "zero"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-rows", type=int, default=4096)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    dt = np.dtype(args.dtype)
    with open(args.out_path, "wb") as f:
        done = 0
        while done < args.rows:
            r = min(args.chunk_rows, args.rows - done)
            if args.fill == "random":
                blk = rng.standard_normal((r, args.cols)).astype(dt)
            elif args.fill == "sequential":
                base = done * args.cols
                blk = (base + np.arange(r * args.cols)).astype(
                    dt).reshape(r, args.cols)
            else:
                blk = np.zeros((r, args.cols), dt)
            f.write(blk.tobytes())
            done += r
    print(f"wrote {args.rows}x{args.cols} {dt.name} to {args.out_path}")


if __name__ == "__main__":
    main()
