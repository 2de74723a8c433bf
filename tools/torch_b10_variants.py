#!/usr/bin/env python3
"""Time B10's design variants against each other and against its first
design on one CUDA card.

    python3 tools/torch_b10_variants.py [--reps 7] [--rounds 2]
        [--inner 10] [--first-design FILE]

`bof_tpu_torch/csrc/sort.cu` sorts a block by a histogram kernel and one
one-sweep kernel a pass (rank, look back, scatter through shared
memory), a block of SORT_THREADS threads a tile of SORT_ITEMS elements
each.  This builds the committed source, four textual edits of it
('items_12': 12 elements a thread; 'threads_256': 256 threads a block,
so four blocks an SM; 'match_any': lanes of one digit found by
__match_any_sync instead of a ballot a bit; 'release_acquire': the
status words published with st.release.gpu and a fence after the
look-back, in place of relaxed accesses) and the first design, a
histogram, a scan and a scatter kernel a pass (FILE, else `git show` of
sort.cu from commit b00fa6e), each by nvcc for sm_90a into its own
library under the port's build root, all at once.  On seeded blocks of
2^24 float32 (N(0, 1), a quarter rounded to 0.01, one in 64 set to +-0,
+-inf or a NaN of either sign with a payload) and uint8 (uniform), and
on all-equal blocks of both, each runs `bof_sort_block` and must give
the plain version's (`sort_block_ref`) bits; then the committed source
and the first design do the same on a seeded block of 2^24 of every kind
B10 takes ('every kind: ...': floats N(0, 1), integers uniform, bool
0/1).  Times are the median of `--reps` CUDA-event samples of `--inner`
calls back to back, each sample queued behind a sleep kernel (so they
time the card alone), in `--rounds` rounds that alternate the variants'
order, beside the bound: the block read once and written once over 3.35
TB/s.  Prints the card's name and power limit, what ptxas notes of each
build (registers, shared memory, spills, a kernel at a time), one line a
measurement and one JSON line.  Needs a card and nvcc; exits 2 without
them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join(HERE, "bof_tpu_torch", "csrc")
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s (data sheet)
N = 1 << 24
ITEMS = "constexpr int SORT_ITEMS = 15;"
THREADS = "constexpr int SORT_THREADS = 512;"
FIRST_COMMIT = "b00fa6e"  # the hist/scan/scatter design is this commit's
FIRST = "first_design"
NAMES = ("committed", "items_12", "threads_256", "match_any",
         "release_acquire", FIRST)
PEERS = "const unsigned peers = same_digit_lanes(d);"
STORE = 'asm volatile("st.relaxed.gpu.global.u64'
PREFIX_FOUND = "if (s[k] >= prefix) return sum;"
KIND_NAMES = {"0": "f32", "1": "f16", "2": "i32", "3": "u32", "4": "i16",
              "5": "u16", "6": "i8", "7": "u8"}


def _first_design(path) -> str:
    """The first design's sort.cu: from `path`, else from git."""
    if path:
        with open(path) as f:
            return f.read()
    res = subprocess.run(
        ["git", "-C", HERE, "show",
         f"{FIRST_COMMIT}:bof_tpu_torch/csrc/sort.cu"],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError("the first design needs --first-design FILE (git "
                           f"show {FIRST_COMMIT}:bof_tpu_torch/csrc/sort.cu "
                           f"failed: {res.stderr.strip()})")
    return res.stdout


def _edit(text: str, *pairs) -> str:
    """text with each (old, new) replaced; each old must occur once."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _variants(src: str, first_path) -> dict:
    return {"committed": src,
            "items_12": _edit(src, (ITEMS, ITEMS.replace("15", "12"))),
            "threads_256": _edit(src, (THREADS, THREADS.replace("512",
                                                                "256"))),
            "match_any": _edit(src, (PEERS, PEERS.replace(
                "same_digit_lanes(d)", "__match_any_sync(FULL, d)"))),
            "release_acquire": _edit(
                src, (STORE, STORE.replace("relaxed", "release")),
                (PREFIX_FOUND, "if (s[k] >= prefix) {\n        "
                 "__threadfence();\n        return sum;\n      }")),
            FIRST: _first_design(first_path)}


def _ptxas_notes(log: str) -> list:
    """One line a kernel instantiation: name, kind, registers, shared
    memory and spills, from ptxas -v."""
    notes, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = re.search(r"sort_\w+?_kernel", mangled)
            kind = re.search(r"ILi(\d)E", mangled)
            entry = (name.group(0) if name else mangled) + (
                f"<{KIND_NAMES[kind.group(1)]}>" if kind else "")
        elif entry and "spill stores" in line:
            spill = line.split(",", 1)[1].strip()
        elif entry and "Used" in line and "registers" in line:
            used = line.split("Used", 1)[1].strip()
            notes.append(f"{entry}: {used}; {spill}")
            entry = None
    return notes


def _build(sources: dict, root: str) -> dict:
    """One nvcc a variant, all at once; name -> (entry point, scratch
    size, ptxas notes)."""
    from bof_tpu_torch.ops import cuda_lib
    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, text in sources.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "sort.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "sort.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        fn = lib.bof_sort_block
        fn.argtypes = cuda_lib._ENTRIES["bof_sort_block"]
        fn.restype = ctypes.c_int
        size = lib.bof_sort_block_scratch_ints
        size.argtypes = cuda_lib._ENTRIES["bof_sort_block_scratch_ints"]
        size.restype = ctypes.c_longlong
        libs[name] = (fn, size, _ptxas_notes(log))
    return libs


def _median_ms(fn, reps: int, inner: int) -> float:
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _inputs(dev):
    """(label, bits, numpy dtype): seeded random and all-equal blocks of
    float32 and uint8, made on the card."""
    import numpy as np
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    x = torch.randn(N, generator=gen, device=dev)
    x[:N // 4] = torch.round(x[:N // 4] * 100) / 100
    f32 = x.view(torch.int32)
    specials = torch.tensor([-0x80000000, 0, 0x7F800000, -0x00800000,
                             0x7FC00000, -0x00400000, 0x7FC00123,
                             -0x007FFFFF], dtype=torch.int32, device=dev)
    at = torch.arange(N // 64, device=dev) * 64 + torch.randint(
        0, 64, (N // 64,), generator=gen, device=dev)
    f32[at] = specials[torch.randint(0, len(specials), (N // 64,),
                                     generator=gen, device=dev)]
    u8 = torch.randint(0, 256, (N,), generator=gen, device=dev,
                       dtype=torch.uint8)
    return (("float32 random", f32, np.float32),
            ("float32 all-equal", torch.full_like(f32, 0x3FC00000),
             np.float32),
            ("uint8 random", u8, np.uint8),
            ("uint8 all-equal", torch.full_like(u8, 7), np.uint8))


def _kind_bits(dev, gen, dt):
    """2^24 seeded elements of numpy dtype dt as bits: floats N(0, 1),
    integers uniform over their range, bool 0/1."""
    import numpy as np
    import torch
    dt = np.dtype(dt)
    if dt.kind == "f":
        x = torch.randn(N, generator=gen, device=dev)
        return x.to(torch.float16).view(torch.int16) if dt.itemsize == 2 \
            else x.view(torch.int32)
    if dt == np.bool_:
        return torch.randint(0, 2, (N,), generator=gen, device=dev,
                             dtype=torch.uint8)
    tdt = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[dt.itemsize]
    wide = torch.randint(-(1 << 62), 1 << 62, (N,), generator=gen,
                         device=dev)
    return (wide & ((1 << (8 * dt.itemsize)) - 1)).to(tdt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--first-design", default=None,
                    help="the first design's source (default: from git)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bof_tpu_torch.io.native import build_root
    from bof_tpu_torch.ops.sort_cuda import SORT_KINDS, sort_block_ref
    with open(os.path.join(CSRC, "sort.cu")) as f:
        sources = _variants(f.read(), args.first_design)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = _build(sources, os.path.join(build_root(), "b10_variants"))
    for name, (_, _, notes) in libs.items():
        print(f"{name}: ptxas", flush=True)
        for note in notes:
            print(f"  {note}", flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results, bounds = {}, {}
    for label, bits, dt in _inputs(dev):
        out = torch.empty_like(bits)
        scratch = torch.empty_like(bits)
        work = {name: torch.empty(size(N), dtype=torch.int32, device=dev)
                for name, (_, size, _) in libs.items()}

        def call(name):
            rc = libs[name][0](out.data_ptr(), bits.data_ptr(),
                               scratch.data_ptr(), work[name].data_ptr(), N,
                               SORT_KINDS[np.dtype(dt)], stream)
            if rc:
                raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

        want = sort_block_ref(bits, dt)
        for name in libs:
            out.zero_()
            call(name)
            torch.cuda.synchronize()
            same = bool(torch.equal(out, want))
            print(f"{label} {name}: bit-identical to the plain version: "
                  f"{same}", flush=True)
            if not same:
                raise AssertionError(f"{label} {name} disagrees")
        order = list(libs)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                results.setdefault(f"{label} {name}", []).append(
                    _median_ms(lambda: call(name), args.reps, args.inner))
        bounds[label] = 2 * N * bits.element_size() / HBM_BPS * 1e3
        del out, scratch, work, want
    # every kind at 2^24, random: the committed source and the first design
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    for dt in SORT_KINDS:
        bits = _kind_bits(dev, gen, dt)
        label = f"every kind: {dt.name}"
        out, scratch = torch.empty_like(bits), torch.empty_like(bits)
        work = {name: torch.empty(libs[name][1](N), dtype=torch.int32,
                                  device=dev) for name in ("committed", FIRST)}

        def call(name):
            rc = libs[name][0](out.data_ptr(), bits.data_ptr(),
                               scratch.data_ptr(), work[name].data_ptr(), N,
                               SORT_KINDS[dt], stream)
            if rc:
                raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

        want = sort_block_ref(bits, dt)
        for name in work:
            out.zero_()
            call(name)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{label} {name} disagrees")
        for r in range(args.rounds):
            for name in (("committed", FIRST) if r % 2 == 0
                         else (FIRST, "committed")):
                results.setdefault(f"{label} {name}", []).append(
                    _median_ms(lambda: call(name), args.reps, args.inner))
        bounds[label] = 2 * N * bits.element_size() / HBM_BPS * 1e3
        del out, scratch, work, want, bits
    for key, times in results.items():
        bound = bounds[key.rsplit(" ", 1)[0]]
        print(f"{key}: " + " / ".join(f"{t:.5f}" for t in times)
              + f" ms on the card alone ({100 * bound / min(times):.1f} % "
              f"of the {bound:.5f} ms bound)", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "bound_ms": bounds, "ms": results,
                      "ptxas": {name: lib[2] for name, lib in libs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
