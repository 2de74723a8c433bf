"""Randomized storage-layer self-test CLI (reference:
misc/flash_file_handle_test.cpp — 1000 randomized read/write/sread/swrite
trials against an iota-filled file, verified arithmetically), over the
port's own store and I/O engine (`--io-backend native` for the C++ engine
in bof_tpu_torch/native/).

    python -m bof_tpu_torch.drivers.file_handle_test [--trials 1000] \
        [--o-direct] [--io-backend auto|native|python]
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from ..io.stride import StrideInfo
from ._common import base_parser, make_context


def main(argv=None) -> int:
    p = base_parser(__doc__)
    p.add_argument("--trials", type=int, default=1000)
    p.add_argument("--elems", type=int, default=1 << 20)
    args = p.parse_args(argv)
    ctx = make_context(args)
    n = args.elems
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(dir=args.scratch) as td:
        path = os.path.join(td, "fht.bin")
        data = np.arange(n, dtype=np.uint32)
        with open(path, "wb") as f:
            f.write(data.tobytes())
        st = ctx.open_store(path)
        shadow = data.copy()
        fails = 0
        for t in range(args.trials):
            kind = t % 4
            if kind == 0:  # contiguous read
                s = int(rng.integers(0, n - 1))
                ln = int(rng.integers(1, min(n - s, 50000)))
                got = st.read_sync(s * 4, StrideInfo.contiguous(ln * 4))
                ok = np.array_equal(got.view(np.uint32), shadow[s:s + ln])
            elif kind == 1:  # strided read
                le = int(rng.integers(1, 500))
                sd = le + int(rng.integers(0, 500))
                ns = int(rng.integers(1, 64))
                ext = (ns - 1) * sd + le
                if ext >= n:
                    continue
                base = int(rng.integers(0, n - ext))
                si = StrideInfo(sd * 4, ns, le * 4)
                got = st.read_sync(base * 4, si).view(np.uint32)
                want = np.concatenate([shadow[base + i * sd:
                                              base + i * sd + le]
                                       for i in range(ns)])
                ok = np.array_equal(got, want)
            elif kind == 2:  # contiguous write
                s = int(rng.integers(0, n - 1))
                ln = int(rng.integers(1, min(n - s, 20000)))
                vals = rng.integers(0, 2**32, ln, dtype=np.uint32)
                st.write_sync(s * 4, StrideInfo.contiguous(ln * 4),
                              vals.view(np.uint8).ravel())
                shadow[s:s + ln] = vals
                ok = True
            else:  # strided write
                le = int(rng.integers(1, 200))
                sd = le + int(rng.integers(0, 300))
                ns = int(rng.integers(1, 32))
                ext = (ns - 1) * sd + le
                if ext >= n:
                    continue
                base = int(rng.integers(0, n - ext))
                vals = rng.integers(0, 2**32, ns * le, dtype=np.uint32)
                st.write_sync(base * 4, StrideInfo(sd * 4, ns, le * 4),
                              vals.view(np.uint8).ravel())
                for i in range(ns):
                    shadow[base + i * sd:base + i * sd + le] = \
                        vals[i * le:(i + 1) * le]
                ok = True
            if not ok:
                fails += 1
                print(f"FAIL trial {t} kind {kind}")
        # final full verification
        got = st.read_sync(0, StrideInfo.contiguous(n * 4)).view(np.uint32)
        if not np.array_equal(got, shadow):
            fails += 1
            print("FAIL final verification")
        st.close()
    print(f"{args.trials} trials, {fails} failures "
          f"({'PASS' if fails == 0 else 'FAIL'})")
    ctx.destroy()
    return 0 if fails == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
