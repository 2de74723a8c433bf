"""Planted controls of the int8 link: the cell run at its own size with a
fault planted in the port in-process, one JSON line of readings a run, as
`oocbench.control` gives the readings of a control set by FlashConfig
fields.  The port has no FlashConfig mode below int8 on the link, so an
int8 cell names its control under `control.planted` in its mix, and this
module runs it.  The benchmark's own runs never run this.

Faults (`--faults`, default the mix's `control.planted`):
  int<b>          each tile quantized to b bits (codes within
                  +/-(2^(b-1) - 1)) with the same one max-abs scale a tile,
                  through the same int8 kernel: `int4` is the next integer
                  precision below int8, `int7` one bit below it
  scale_x2        every third tile's scale doubled
  dropped_k_step  every other K step's product left out

    python3 -m oocbench.planted --workload sgemm_fig5.int8 --seeds 1 2 3 \
        --seconds 8 [--faults int4 int7 scale_x2] [--program]
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import re
import sys

import numpy as np

from . import run as R


def coarse_quantizer(bits: int):
    """`quantize_i8`'s contract on a grid of 2^(bits-1) - 1 steps a side:
    (int8 codes, scale) with scale = max|x| / qmax in fp32 (an all-zero
    tile gets max 1), codes rint(x / scale) clamped to +/-qmax."""
    import torch
    qmax = 2 ** (bits - 1) - 1

    def quantize(src: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(src, np.float32))
        amax = np.float32(float(x.abs().max()) if x.numel() else 0.0)
        scale = (amax if amax > 0 else np.float32(1)) / np.float32(qmax)
        q = torch.round(x * float(np.float32(1) / scale))
        return (q.clamp_(-qmax, qmax).to(torch.int8).numpy(),
                float(scale))
    return quantize


def _every_other(fn):
    state = {"n": 0}

    def skip_half(c, *args, **kw):
        state["n"] += 1
        return fn(c, *args, **kw) if state["n"] % 2 else c
    return skip_half


@contextlib.contextmanager
def planted(fault: str):
    """The port with `fault` planted while the block runs."""
    gemm = importlib.import_module("bof_tpu_torch.ops.gemm")
    dev = importlib.import_module("bof_tpu_torch.ops.device")
    bits = re.fullmatch(r"int([2-7])", fault)
    if bits:
        mod, name, new = gemm, "quantize_i8", coarse_quantizer(
            int(bits.group(1)))
    elif fault == "scale_x2":
        real, state = gemm.quantize_i8, {"n": 0}

        def new(host):
            q, scale = real(host)
            state["n"] += 1
            return q, scale * 2 if state["n"] % 3 == 0 else scale
        mod, name = gemm, "quantize_i8"
    elif fault == "dropped_k_step":
        mod, name = dev, "accum_step_q"
        new = _every_other(dev.accum_step_q)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    old = getattr(mod, name)
    setattr(mod, name, new)
    try:
        yield
    finally:
        setattr(mod, name, old)


def readings(workload: str, seed: int, seconds: float,
             fault: str | None, device: str = "cuda") -> dict:
    """One run of `workload` with `fault` planted (None: the program)."""
    _, config, mix = R.resolve(R.load_manifest(), workload)
    with planted(fault) if fault else contextlib.nullcontext():
        rec = R.run(config, mix, seed, seconds, False, device=device,
                    log=lambda s: print(s, file=sys.stderr, flush=True))
    return {"workload": workload, "seed": seed,
            "side": "planted" if fault else "program", "fault": fault,
            "attempted": rec["attempted"], "failed": rec["failed"],
            "rel_err": rec["checks"]["rel_err"]["value"],
            "limit": rec["checks"]["rel_err"]["limit"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--faults", nargs="+")
    p.add_argument("--program", action="store_true",
                   help="also read the program as the cell runs it")
    args = p.parse_args(argv)
    cell, _, mix = R.resolve(R.load_manifest(), args.workload)
    R.require_card(cell["chips"])
    faults = args.faults or [mix["control"]["planted"]]
    for seed in args.seeds:
        for fault in faults + ([None] if args.program else []):
            print(json.dumps(readings(args.workload, seed, args.seconds,
                                      fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
