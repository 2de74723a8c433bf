#!/usr/bin/env python3
"""Time the copy of gemm's C ring slots into a DRAM `MemStore`, several
ways, on the host that runs the card.

    python3 tools/torch_store_copy_premise.py [--reps 5] [--out FILE]

The destination is a faulted-in 1 GiB store, C of a 2^14 x 2^14 fp32
gemm (rows of 64 KiB).  A "call" copies C once from a 32 MiB slot, as
`ops/device.py:D2HRing` hands it to the writer: 32 writes, each at the
resident cell's shape (1024 storage rows of 32 KiB at a 64 KiB stride,
one eighth of an 8192-wide C block), or, as `contig`, 32 contiguous
32 MiB runs.  The slot is page-locked where a card is present.  Ways:

- `rows`: one slice assignment a storage row (the store's first design);
- `strided`: one 2-D numpy assignment into a strided view of the store;
- `split<N>.persistent`: the 2-D copy cut into N row ranges, N - 1 on
  threads that persist across writes, one on the calling thread;
- `split<N>.spawned`: the same with N - 1 threads started a write;
- `memstore`: `MemStore.write` as the package has it.

`sizes` repeats `strided` and `split<N>.persistent` at writes of 1 to
32 MiB (rows of 32 KiB), to place the split's threshold and the least
bytes a worker.  Prints the card's name and power limit, one line a
measurement and one JSON line (also written to `--out`).  Needs no card.
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
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

C_ROWS, C_ROW_BYTES = 16384, 65536     # C: 2^14 x 2^14 fp32
LPS, SLOT_ROWS = 32768, 1024           # a slot: 1024 rows of 32 KiB
SLOT_BYTES = LPS * SLOT_ROWS
WORKERS = (1, 2, 4, 8)


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _slot():
    import numpy as np
    try:
        import torch
        if torch.cuda.is_available():
            return torch.empty(SLOT_BYTES, dtype=torch.uint8,
                               pin_memory=True).numpy(), True
    except ImportError:
        pass
    return np.empty(SLOT_BYTES, np.uint8), False


def main(argv=None) -> int:
    import numpy as np

    from bof_tpu_torch.io.store import MemStore
    from bof_tpu_torch.io.stride import StrideInfo

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/store_copy_premise.json")
    args = ap.parse_args(argv)

    res = {"card": _card(), "cpus": os.cpu_count(),
           "slot_bytes": SLOT_BYTES, "call_bytes": C_ROWS * C_ROW_BYTES}
    print("card:", res["card"], "cpus", res["cpus"], flush=True)
    slot, res["slot_pinned"] = _slot()
    slot[:] = np.random.default_rng(0).integers(0, 256, SLOT_BYTES,
                                                dtype=np.uint8)
    store = MemStore(C_ROWS * C_ROW_BYTES)
    data = store._data
    data.fill(1)  # fault every page in

    sinfo = StrideInfo(C_ROW_BYTES, SLOT_ROWS, LPS)
    contig = StrideInfo.contiguous(SLOT_BYTES)
    # a call's 32 writes: 4 blocks of 8192 x 8192 fp32, 8 slots each
    strided_offs = [(bi * 8192 + s * SLOT_ROWS) * C_ROW_BYTES + bj * LPS
                    for bi in range(2) for bj in range(2) for s in range(8)]
    contig_offs = [k * SLOT_BYTES for k in range(32)]

    def view(off, si, nrows=None):
        n = si.n_strides if nrows is None else nrows
        return (np.lib.stride_tricks.as_strided(
            data[off:], shape=(n, si.len_per_stride), strides=(si.stride, 1)),
            slot[:n * si.len_per_stride].reshape(n, si.len_per_stride))

    def rows(off, si):
        for i in range(si.n_strides):
            fo, bo = off + i * si.stride, i * si.len_per_stride
            data[fo:fo + si.len_per_stride] = slot[bo:bo + si.len_per_stride]

    def strided(off, si, nrows=None):
        dst, src = view(off, si, nrows)
        dst[...] = src

    pools = {n: ThreadPoolExecutor(n - 1) for n in WORKERS if n > 1}

    def cuts(n_rows, n):
        return [(i * n_rows // n, (i + 1) * n_rows // n) for i in range(n)]

    def split(n, spawned):
        def copy(off, si, nrows=None):
            if si.n_strides == 1:  # one run: cut its bytes instead
                w = si.nbytes // n
                dst = np.lib.stride_tricks.as_strided(
                    data[off:], shape=(n, w), strides=(w, 1))
                src = slot[:n * w].reshape(n, w)
            else:
                dst, src = view(off, si, nrows)
            parts = cuts(dst.shape[0], n)

            def one(r0, r1):
                dst[r0:r1] = src[r0:r1]

            if n == 1:
                one(*parts[0])
            elif spawned:
                ts = [threading.Thread(target=one, args=p)
                      for p in parts[1:]]
                for t in ts:
                    t.start()
                one(*parts[0])
                for t in ts:
                    t.join()
            else:
                fs = [pools[n].submit(one, *p) for p in parts[1:]]
                one(*parts[0])
                for f in fs:
                    f.result()
        return copy

    def memstore(off, si):
        store.write(off, si, slot).wait()

    ways = {"rows": rows, "strided": strided, "memstore": memstore}
    for n in WORKERS:
        ways[f"split{n}.persistent"] = split(n, False)
        ways[f"split{n}.spawned"] = split(n, True)

    want = None
    for shape, si, offs in (("resident", sinfo, strided_offs),
                            ("contig", contig, contig_offs)):
        for name, fn in ways.items():
            def one_call():
                s = time.perf_counter()
                for off in offs:
                    fn(off, si)
                return time.perf_counter() - s
            one_call()  # warm
            xs = [one_call() for _ in range(args.reps)]
            med = statistics.median(xs)
            key = f"{shape}.{name}"
            res[key] = {"s": xs, "median_s": med,
                        "gbps": res["call_bytes"] / med / 1e9}
            print(f"{key:32s} median {med * 1e3:9.2f} ms a call  "
                  f"{res['call_bytes'] / med / 1e9:7.2f} GB/s  "
                  f"runs {[round(x * 1e3, 2) for x in xs]}", flush=True)
            got = data[::4097].copy()
            if want is None:
                want = got
            elif not np.array_equal(got, want):
                print(f"{key}: wrong bytes", file=sys.stderr)
                return 1
        want = None

    # write size against worker count, strided rows of 32 KiB
    size_ways = {"strided": strided}
    size_ways.update({f"split{n}.persistent": split(n, False)
                      for n in WORKERS if n > 1})
    for mib in (1, 2, 4, 8, 16, 32):
        nrows = mib * (1 << 20) // LPS
        for name, fn in size_ways.items():
            def timed():
                s = time.perf_counter()
                for off in strided_offs:
                    fn(off, sinfo, nrows)
                return time.perf_counter() - s
            timed()
            xs = [timed() for _ in range(args.reps)]
            med = statistics.median(xs)
            nbytes = len(strided_offs) * nrows * LPS
            key = f"sizes.{mib}MiB.{name}"
            res[key] = {"s": xs, "median_s": med, "gbps": nbytes / med / 1e9,
                        "us_a_write": med / len(strided_offs) * 1e6}
            print(f"{key:32s} {med / len(strided_offs) * 1e6:9.1f} us a write  "
                  f"{nbytes / med / 1e9:7.2f} GB/s", flush=True)

    for p in pools.values():
        p.shutdown()
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: (round(v["gbps"], 3) if isinstance(v, dict) else v)
                      for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
