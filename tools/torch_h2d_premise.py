#!/usr/bin/env python3
"""Upload one 8192 x 8192 fp32 tile (256 MiB) held in a 4096-aligned
`posix_memalign` buffer, as the native pin cache holds one, to a CUDA
card three ways, and time each.

    python3 tools/torch_h2d_premise.py [--reps 5] [--out FILE]

(a) `pageable`: the upload as it was, `torch.from_numpy(tile).to(card)`:
    the driver stages every byte through its own pageable bounce buffers;
(b) `register_each`: `cudaHostRegister` of the tile, its upload, then
    `cudaHostUnregister`: what a lock a use would cost;
(c) `registered`: an upload from the tile registered once, as a Program
    Cache buffer is after its first whole upload;
(d) `host_alloc`: an upload from a `cudaHostAlloc` buffer (the fallback
    where registration is refused), with the allocation's own seconds.

The runtime functions are the ones the pin cache is handed
(`ops/device.py:host_lock_fns`), called through their addresses.  Each
upload is checked byte for byte.  A short torch.profiler capture of (c)
names its copy.  Prints the card's name and power limit, one line a
measurement and one JSON line (also written to `--out`).  Needs a card;
exits 2 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROWS, COLS = 8192, 8192


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bof_tpu_torch.ops.device import _cudart, host_lock_fns

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/h2d_premise.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    nbytes = ROWS * COLS * 4
    res = {"card": _card(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "tile_bytes": nbytes}
    print("card:", res["card"], "torch", torch.__version__, flush=True)

    fns = host_lock_fns(dev)
    res["cudart"] = getattr(_cudart(), "_name", None)
    if fns is None:
        print("no CUDA runtime found", file=sys.stderr)
        return 1
    register = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.c_uint)(fns[0])
    unregister = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)(fns[1])
    last_error = ctypes.CFUNCTYPE(ctypes.c_int)(fns[2])
    print("cudart:", res["cudart"], flush=True)

    libc = ctypes.CDLL(None)
    libc.posix_memalign.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.c_size_t, ctypes.c_size_t]
    libc.free.argtypes = [ctypes.c_void_p]
    ptr = ctypes.c_void_p()
    if libc.posix_memalign(ctypes.byref(ptr), 4096, nbytes) != 0:
        print("posix_memalign failed", file=sys.stderr)
        return 1
    addr = ptr.value
    tile = np.frombuffer((ctypes.c_char * nbytes).from_address(addr),
                         np.float32).reshape(ROWS, COLS)
    tile[...] = np.random.default_rng(0).standard_normal(
        (ROWS, COLS), dtype=np.float32)
    want = torch.from_numpy(tile.copy())

    def timed(fn):
        torch.cuda.synchronize(dev)
        s = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - s, out

    def record(key, fn, check):
        fn()  # warm
        xs = []
        for _ in range(args.reps):
            s, out = timed(fn)
            xs.append(s)
        if check is not None and not torch.equal(out.cpu(), check):
            print(f"{key}: wrong bytes", file=sys.stderr)
            raise SystemExit(1)
        med = statistics.median(xs)
        res[key] = {"s": xs, "median_s": med, "gbps": nbytes / med / 1e9}
        print(f"{key:22s} median {med * 1e3:9.2f} ms  "
              f"{nbytes / med / 1e9:7.2f} GB/s  "
              f"runs {[round(x * 1e3, 2) for x in xs]}", flush=True)

    def upload():
        return torch.from_numpy(tile).to(dev, copy=True)

    res["pageable.is_pinned"] = torch.from_numpy(tile).is_pinned()
    record("pageable", upload, want)

    reg_s = []

    def register_each():
        s = time.perf_counter()
        r = register(addr, nbytes, 0)
        reg_s.append(time.perf_counter() - s)
        if r != 0:
            last_error()
            raise RuntimeError(f"cudaHostRegister returned {r}")
        try:
            return upload()
        finally:
            unregister(addr)

    try:
        record("register_each", register_each, want)
        res["register_s"] = reg_s
        print(f"register alone: median {statistics.median(reg_s) * 1e3:.2f} "
              f"ms", flush=True)
        res["registered_ok"] = True
    except RuntimeError as e:
        res["registered_ok"] = False
        res["register_error"] = str(e)
        print("register refused:", e, flush=True)

    if res["registered_ok"]:
        register(addr, nbytes, 0)
        res["registered.is_pinned"] = torch.from_numpy(tile).is_pinned()
        record("registered", upload, want)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            upload()
            torch.cuda.synchronize(dev)
        out_dir = os.path.dirname(args.out) or "."
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "h2d_premise_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        res["registered_copies"] = sorted({e["name"] for e in evs
                                           if e.get("cat") == "gpu_memcpy"})
        print("registered copies:", res["registered_copies"], flush=True)
        res["unregister_rc"] = unregister(addr)

    s = time.perf_counter()
    pinned = torch.empty(nbytes // 4, dtype=torch.float32, pin_memory=True)
    res["host_alloc_s"] = time.perf_counter() - s
    pinned.view(ROWS, COLS).copy_(want)
    record("host_alloc", lambda: pinned.view(ROWS, COLS).to(dev, copy=True),
           want)
    libc.free(addr)

    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: (v["median_s"] if isinstance(v, dict) else v)
                      for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
