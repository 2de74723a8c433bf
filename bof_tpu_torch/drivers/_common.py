"""Shared CLI plumbing for drivers (reference: every driver under
drivers/ parses argv, map_files its operands, times one kernel)."""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from ..config import FlashConfig
from ..context import FlashContext


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--scratch",
                   default=os.path.join(tempfile.gettempdir(),
                                        "bof_tpu_torch_scratch"),
                   help="scratch dir for temporaries (flash_setup mnt_dir)")
    p.add_argument("--budget-gb", type=float, default=8.0,
                   help="host tile cache budget (PROGRAM_BUDGET)")
    p.add_argument("--io-threads", type=int, default=8)
    p.add_argument("--compute-threads", type=int, default=4)
    p.add_argument("--o-direct", action="store_true",
                   help="open data files with O_DIRECT")
    p.add_argument("--io-backend", default="auto",
                   choices=["auto", "native", "python"],
                   help="native = the C++ O_DIRECT/AIO engine (an error if "
                        "it cannot be built), python = the thread-pool "
                        "fallback, auto = native when it builds")
    p.add_argument("--precision", default="highest",
                   choices=["default", "high", "highest"],
                   help="matmul precision on device")
    p.add_argument("--sparse-compute", default="auto",
                   choices=["auto", "host", "device"],
                   help="placement of sparse block products (csrmm, "
                        "csrgemv): device = the ELL kernels on the card, "
                        "host = scipy on the pinned tile (the reference's "
                        "MKL-on-host model), auto = by measured link rate")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (cuda, cuda:N, cpu); "
                        "never auto-detected")
    return p


def make_context(args) -> FlashContext:
    cfg = FlashConfig(
        scratch_dir=args.scratch,
        program_budget=int(args.budget_gb * (1 << 30)),
        n_io_threads=args.io_threads,
        n_compute_threads=args.compute_threads,
        use_o_direct=args.o_direct,
        io_backend=args.io_backend,
        matmul_precision=args.precision,
        sparse_compute=args.sparse_compute,
        device=args.device)
    return FlashContext(cfg)


class Timed:
    def __init__(self, label: str, flops: float = 0.0, nbytes: float = 0.0):
        self.label, self.flops, self.nbytes = label, flops, nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.seconds = dt
        msg = f"[{self.label}] {dt:.3f} s"
        if self.flops:
            msg += f"  {self.flops / dt / 1e9:.1f} GFLOP/s"
        if self.nbytes:
            msg += f"  {self.nbytes / dt / 1e9:.2f} GB/s"
        print(msg, file=sys.stderr)


def checksum(x: np.ndarray) -> float:
    return float(np.asarray(x, dtype=np.float64).sum())
