#!/usr/bin/env python3
"""Download one finished 8192 x 8192 fp32 C block (256 MiB) from a CUDA
card three ways, alone and beside a gemm-like load, and time each.

    python3 tools/torch_d2h_premise.py [--reps 5] [--out FILE]

(a) `fresh`: the writer's old path, `t.cpu().numpy()`: a new pageable
    256 MiB array a block, copied synchronously on the default stream;
(b) `pageable_pieces`: one reused pageable 32 MiB buffer, the block going
    down 1024 rows at a time, each piece copied synchronously;
(c) `pinned_ring`: two reused page-locked 32 MiB slots on a copy stream
    of their own, a piece's copy queued while the host consumes the
    other slot.

Each way is timed with the host's consumer, a copy of each piece into a
256 MiB destination that stands for C's DRAM store (`+store`), and
without it (`link`).  `loaded` repeats the three `+store` timings while a
second thread uploads 256 MiB pageable tiles and multiplies them on the
default stream, as gemm's producer and K1 do; it also reports that
thread's upload rate.  A short torch.profiler capture of one (c) block
names its copies and their streams.  Prints the card's name and power
limit, one line a measurement and one JSON line (also written to
`--out`).  Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROWS, COLS = 8192, 8192
PIECE_ROWS = 1024  # 32 MiB of fp32 rows


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

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/d2h_premise.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    res = {"card": _card(), "torch": torch.__version__,
           "block_bytes": ROWS * COLS * 4,
           "piece_bytes": PIECE_ROWS * COLS * 4}
    print("card:", res["card"], "torch", torch.__version__, flush=True)

    t = torch.randn(ROWS, COLS, device=dev)
    want = t.cpu().numpy()
    dst = np.empty((ROWS, COLS), np.float32)
    dst.fill(0)
    pieces = [(r, min(r + PIECE_ROWS, ROWS)) for r in range(0, ROWS,
                                                            PIECE_ROWS)]

    def fresh(store):
        x = t.cpu().numpy()
        if store:
            dst[...] = x

    pageable = torch.empty(PIECE_ROWS * COLS, dtype=torch.float32)
    pageable.fill_(0)

    def pageable_pieces(store):
        for r0, r1 in pieces:
            v = pageable[:(r1 - r0) * COLS].view(r1 - r0, COLS)
            v.copy_(t[r0:r1])
            if store:
                dst[r0:r1] = v.numpy()

    t0 = time.perf_counter()
    try:
        slots = [torch.empty(PIECE_ROWS * COLS, dtype=torch.float32,
                             pin_memory=True) for _ in range(2)]
        res["pin_alloc_s"] = time.perf_counter() - t0
        res["pinned"] = True
    except RuntimeError as e:
        res["pinned"] = False
        res["pin_error"] = str(e)
        slots = [torch.empty(PIECE_ROWS * COLS, dtype=torch.float32)
                 for _ in range(2)]
    stream = torch.cuda.Stream(dev)
    events = [torch.cuda.Event(), torch.cuda.Event()]

    def pinned_ring(store):
        stream.wait_stream(torch.cuda.current_stream(dev))
        pending = []

        def drain(k):
            events[k % 2].synchronize()
            r0, r1 = pieces[k]
            if store:
                dst[r0:r1] = slots[k % 2][:(r1 - r0) * COLS].view(
                    r1 - r0, COLS).numpy()

        for k, (r0, r1) in enumerate(pieces):
            if len(pending) == 2:
                drain(pending.pop(0))
            with torch.cuda.stream(stream):
                slots[k % 2][:(r1 - r0) * COLS].view(r1 - r0, COLS).copy_(
                    t[r0:r1], non_blocking=True)
                events[k % 2].record(stream)
            pending.append(k)
        for k in pending:
            drain(k)

    ways = {"fresh": fresh, "pageable_pieces": pageable_pieces,
            "pinned_ring": pinned_ring}

    def timed(fn, store):
        torch.cuda.synchronize(dev)
        s = time.perf_counter()
        fn(store)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - s

    for name, fn in ways.items():
        for store in (False, True):
            fn(store)  # warm
            xs = [timed(fn, store) for _ in range(args.reps)]
            key = f"{name}.{'+store' if store else 'link'}"
            med = statistics.median(xs)
            res[key] = {"s": xs, "median_s": med,
                        "gbps": res["block_bytes"] / med / 1e9}
            print(f"{key:28s} median {med * 1e3:9.2f} ms  "
                  f"{res['block_bytes'] / med / 1e9:7.2f} GB/s  "
                  f"runs {[round(x * 1e3, 2) for x in xs]}", flush=True)
        if not np.array_equal(dst, want):
            print(f"{name}: wrong bytes", file=sys.stderr)
            return 1
        dst.fill(0)

    # beside a gemm-like load on the default stream
    stop = threading.Event()
    up_bytes = [0, 0.0]
    a_dev = torch.randn(ROWS, COLS, device=dev)

    def load():
        host = np.random.default_rng(0).standard_normal(
            (ROWS, COLS), dtype=np.float32)
        s = time.perf_counter()
        while not stop.is_set():
            b = torch.from_numpy(host).to(dev)
            torch.mm(a_dev[:2048], b[:, :2048])
            up_bytes[0] += host.nbytes
        torch.cuda.synchronize(dev)
        up_bytes[1] = time.perf_counter() - s

    th = threading.Thread(target=load, daemon=True)
    th.start()
    time.sleep(1.0)
    try:
        for name, fn in ways.items():
            xs = [timed(fn, True) for _ in range(args.reps)]
            med = statistics.median(xs)
            res[f"loaded.{name}"] = {"s": xs, "median_s": med,
                                     "gbps": res["block_bytes"] / med / 1e9}
            print(f"loaded.{name:21s} median {med * 1e3:9.2f} ms  "
                  f"{res['block_bytes'] / med / 1e9:7.2f} GB/s  "
                  f"runs {[round(x * 1e3, 2) for x in xs]}", flush=True)
    finally:
        stop.set()
        th.join(timeout=60)
    res["loaded.upload_gbps"] = up_bytes[0] / max(up_bytes[1], 1e-9) / 1e9
    print(f"loaded.upload_gbps {res['loaded.upload_gbps']:.2f}", flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pinned_ring(False)
        torch.cuda.synchronize(dev)
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "d2h_premise_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    copies = {}
    for e in evs:
        if e.get("cat") == "gpu_memcpy":
            k = (e["name"], e.get("args", {}).get("stream"))
            copies[k] = copies.get(k, 0) + 1
    res["ring_copies"] = [[n, s, c] for (n, s), c in copies.items()]
    res["default_stream"] = torch.cuda.default_stream(dev).stream_id
    res["ring_stream"] = stream.stream_id
    print("ring copies (name, stream, count):", res["ring_copies"],
          "default stream id", res["default_stream"], flush=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: (v["median_s"] if isinstance(v, dict) else v)
                      for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
