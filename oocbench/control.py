"""The control of `correct`: the program with the mix's `control` fields
(the next precision down: K1 at one TF32 pass for the dense cells, bf16
values for the sparse ones) at the cell's own size, and beside it, with
`--program`, the program as the cell runs it: one JSON line of readings a
run.  The benchmark's own runs never run this.

    python3 -m oocbench.control --workload <cell> --seeds 1 2 3 \
        --seconds 8 [--program]
"""
from __future__ import annotations

import argparse
import json
import sys

from . import run as R


def readings(workload: str, seed: int, seconds: float,
             control: bool) -> dict:
    _, config, mix = R.resolve(R.load_manifest(), workload)
    fields = dict(mix["control"]) if control else {}
    rec = R.run(config, mix, seed, seconds, False, overrides=fields,
                log=lambda s: print(s, file=sys.stderr, flush=True))
    return {"workload": workload, "seed": seed,
            "side": "control" if control else "program",
            "fields": fields, "attempted": rec["attempted"],
            "failed": rec["failed"],
            "rel_err": rec["checks"]["rel_err"]["value"],
            "limit": rec["checks"]["rel_err"]["limit"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--program", action="store_true",
                   help="also read the program as the cell runs it")
    args = p.parse_args(argv)
    cell, _, _ = R.resolve(R.load_manifest(), args.workload)
    R.require_card(cell["chips"])
    for seed in args.seeds:
        sides = (True, False) if args.program else (True,)
        for control in sides:
            print(json.dumps(readings(args.workload, seed, args.seconds,
                                      control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
