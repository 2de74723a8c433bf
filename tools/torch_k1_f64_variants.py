#!/usr/bin/env python3
"""Time design variants of K1's float64 kernel on one CUDA card.

    python3 tools/torch_k1_f64_variants.py [--reps 5] [--rounds 2] [--only a,b]
        [--first-design FILE]

Each variant is `bof_tpu_torch/csrc/matmul_f64.cu` with a few textual
edits (`_variants` below: the MMA shape, the ring's stage count, the K
tile, the raster group, how far the copy loops unroll, or the mainloop
that loads each step's fragments only after the tile's barrier), or the
kernel's first design (m8n8k4 DMMA on a 128x64 tile through two
register-staged slabs: FILE, else `git show` of it from commit 2b41c0d),
each compiled by nvcc for sm_90a into its own library under the port's
build root, all at once.  At the pipeline's superblock (8192^3) each runs
`bof_accum_matmul_f64` with alpha -1.5 on a non-zero C, on three layouts:
R/N/N, S10's R/N/T, and R/N/N on operands whose leading dimension is 8193
(odd: 8-byte copies).  Every result must lie within bof_tpu's scaled bound
1e-12 * k * max|A row| * max|B col| * |alpha| of torch.mm in float64, and
the line says whether its bits equal the committed build's.  Times are the
median of `--reps` CUDA-event samples, taken in `--rounds` rounds that
alternate the variants' order, beside torch.mm float64 (the library
yardstick) and the bound (2 * 8192^3 operations at 67 TFLOP/s).  Prints
the card's name and power limit, what ptxas notes of each build, one line
a measurement and one JSON line.  Needs a card and nvcc; exits 2 without
them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
SOURCE = os.path.join(HERE, "bof_tpu_torch", "csrc", "matmul_f64.cu")
FIRST_COMMIT = "2b41c0d"  # the first design is this commit's matmul_f64.cu
FP64_FLOPS = 67e12  # H100 SXM fp64 tensor cores, FLOP/s (data sheet)

MAINLOOP_START = "  // fragments of K step kk of the tile in stage st"
MAINLOOP_END = "  cp_async_wait<0>();\n"
DMMA_K4 = """      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));"""
DMMA = {
    8: """      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));""",
    16: """      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));""",
}
# the mainloop without fragment prefetch: STAGES - 1 tiles in flight, and
# after each tile's barrier every step loads its fragments, then its MMAs
PLAIN_MAINLOOP = """#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < ktiles) load_stage(kt);
    cp_async_commit();  // an empty group keeps the count of groups fixed
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();              // ... every thread's; stage kt-1 is free
    if (kt + STAGES - 1 < ktiles) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const double* as = As + (kt % STAGES) * TA::SIZE;
    const double* bs = Bs + (kt % STAGES) * TB::SIZE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += MMA_K) {
      double bf[NT][KV];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < KV; ++v)
          bf[j][v] = bs[TB::at(wn + 8 * j + gid, kk + tig + 4 * v)];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        double af[2 * KV];
#pragma unroll
        for (int v = 0; v < 2 * KV; ++v)
          af[v] = as[TA::at(wm + 16 * i + gid + 8 * (v % 2),
                            kk + tig + 4 * (v / 2))];
#pragma unroll
        for (int j = 0; j < NT; ++j) dmma(acc[i][j], af, bf[j]);
      }
    }
  }
"""

# every variant but the first design keeps the committed design unless it
# says otherwise: m16n8k4, 4 stages of BK 16, fragments loaded a step
# ahead, rasters of 8 block rows, 16-byte copies unrolled and 8-byte ones
# two at a time
NAMES = ("committed", "m8n8k4_first_design", "mma_k8", "no_prefetch_mma_k16",
         "no_prefetch_mma_k4", "stages_3", "stages_2", "bk32_stages_3",
         "row_raster", "narrow_copies_unrolled", "narrow_copies_rolled",
         "wide_copies_rolled")
# name -> (a_km, b_nk, c_nm, padded leading dimensions)
LAYOUTS = {"R/N/N": (0, 0, 0, False), "R/N/T (S10)": (0, 1, 0, False),
           "R/N/N ld 8193": (0, 0, 0, True)}


def _edit(text: str, *pairs) -> str:
    """text with each (old, new) replaced; each old must occur once."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _const(name: str, old: int, new: int):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


def _plain_mainloop(text: str) -> str:
    """text with PLAIN_MAINLOOP in place of its mainloop."""
    start, end = text.index(MAINLOOP_START), text.index(MAINLOOP_END)
    return _edit(text[:start] + PLAIN_MAINLOOP + text[end:],
                 ("static_assert(KSTEPS % 2 == 0", "static_assert(true"))


def _mma_k(text: str, k: int) -> str:
    """text on the m16n8k{k} shape."""
    return _edit(text, _const("MMA_K", 4, k), (DMMA_K4, DMMA[k]))


def _first_design(path: str) -> str:
    if path:
        with open(path) as f:
            return f.read()
    res = subprocess.run(
        ["git", "-C", HERE, "show",
         f"{FIRST_COMMIT}:bof_tpu_torch/csrc/matmul_f64.cu"],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError("the first design needs --first-design FILE (git "
                           f"show {FIRST_COMMIT}:bof_tpu_torch/csrc/"
                           f"matmul_f64.cu) where the repo has no history: "
                           f"{res.stderr.strip()}")
    return res.stdout


def _variants(names, first_path: str) -> dict:
    """name -> source text."""
    with open(SOURCE) as f:
        src = f.read()
    make = {
        "committed": lambda: src,
        "m8n8k4_first_design": lambda: _first_design(first_path),
        "mma_k8": lambda: _mma_k(src, 8),
        "no_prefetch_mma_k16": lambda: _plain_mainloop(_mma_k(src, 16)),
        "no_prefetch_mma_k4": lambda: _plain_mainloop(src),
        "stages_3": lambda: _edit(src, _const("STAGES", 4, 3)),
        "stages_2": lambda: _edit(src, _const("STAGES", 4, 2)),
        "bk32_stages_3": lambda: _edit(src, _const("BK", 16, 32),
                                       _const("STAGES", 4, 3)),
        "row_raster": lambda: _edit(src, _const("GROUP_M", 8, 1)),
        "narrow_copies_unrolled": lambda: _edit(
            src, _const("NARROW_UNROLL", 2, 8)),
        "narrow_copies_rolled": lambda: _edit(
            src, _const("NARROW_UNROLL", 2, 1)),
        "wide_copies_rolled": lambda: _edit(src, _const("WIDE_UNROLL", 4, 1)),
    }
    return {name: make[name]() for name in names}


def _ptxas_notes(log: str) -> list:
    """Registers over the kernel's instantiations, and each instantiation
    that spills (by its template arguments: a_km, b_nk and, for the
    committed design, the A and B copy widths)."""
    regs, spills, entry = [], [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            args = mangled.split("kernelI")[-1].split("EE")[0]
            entry = ",".join(t[-1] for t in args.split("E"))
        elif "Used " in line and "registers" in line:
            regs.append(int(line.split("Used ")[1].split()[0]))
        elif "spill stores" in line and " 0 bytes spill stores" not in line:
            spills.append(f"<{entry}> {line.strip()}")
    return [f"{min(regs)}-{max(regs)} registers over {len(regs)} "
            "instantiations", "spills: " + ("; ".join(spills) or "none")]


def _build(sources: dict, root: str) -> dict:
    """One nvcc a variant, all at once; name -> (entry point, ptxas notes)."""
    from bof_tpu_torch.ops import cuda_lib
    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, text in sources.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "matmul_f64.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_lib.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-shared", "-o",
             os.path.join(d, "lib.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(root, name, "lib.so")
                         ).bof_accum_matmul_f64
        fn.argtypes = cuda_lib._ENTRIES["bof_accum_matmul_f64"]
        fn.restype = ctypes.c_int
        libs[name] = (fn, _ptxas_notes(log))
    return libs


def _median_ms(fn, reps):
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (committed always)")
    ap.add_argument("--first-design", default="",
                    help="the first design's source (default: from git)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bof_tpu_torch.io.native import build_root
    names = list(NAMES)
    if args.only:
        names = ["committed"] + [n for n in args.only.split(",")
                                 if n != "committed"]
    sources = _variants(names, args.first_design)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = _build(sources, os.path.join(build_root(), "k1_f64_variants"))
    for name, (_, notes) in libs.items():
        print(f"{name}: ptxas " + "; ".join(notes), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = 8192
    alpha = -1.5
    results, checks = {}, {}
    for lay, (a_km, b_nk, c_nm, padded) in LAYOUTS.items():
        ld = n + 1 if padded else n
        a_full = torch.randn((n, ld), generator=gen, device=dev,
                             dtype=torch.float64)
        b_full = torch.randn((n, ld), generator=gen, device=dev,
                             dtype=torch.float64)
        c0 = torch.randn((n, n), generator=gen, device=dev,
                         dtype=torch.float64)
        a, b = a_full[:, :n], b_full[:, :n]
        opb = b.T if b_nk else b
        want = torch.addmm(c0, a, opb, alpha=alpha)
        lim = 1e-12 * n * abs(alpha) * (a.abs().amax(1)[:, None]
                                        * opb.abs().amax(0)[None, :])

        def call(fn, c):
            rc = fn(c.data_ptr(), a_full.data_ptr(), b_full.data_ptr(), alpha,
                    n, n, n, a_km, b_nk, c_nm, ld, ld, n, stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        ref_bits = None
        for name, (fn, _) in libs.items():
            c = c0.clone()
            call(fn, c)
            torch.cuda.synchronize()
            ratio = float(((c - want).abs() / lim).max())
            if name == "committed":
                ref_bits = c
            same = bool(torch.equal(c, ref_bits))
            checks[f"{lay} {name}"] = {"err_over_bound": ratio,
                                       "bits_equal_committed": same}
            print(f"{lay} {name}: max |kernel - torch.mm| / bound {ratio:.3g}"
                  f"{'' if ratio <= 1 else ' FAIL'}; bits equal the committed"
                  f" build's: {same}", flush=True)
            if ratio > 1:
                raise AssertionError(f"{lay} {name} disagrees with torch.mm")
            del c
        del want, lim, ref_bits
        order = list(libs)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                fn = libs[name][0]
                c = c0.clone()
                results.setdefault(f"{lay} {name}", []).append(
                    _median_ms(lambda: call(fn, c), args.reps))
                del c
        results[f"{lay} library torch.mm float64"] = [
            _median_ms(lambda: torch.mm(a, opb), args.reps)]
        del a_full, b_full, c0, a, b, opb
        torch.cuda.empty_cache()
    bound = 2.0 * n ** 3 / FP64_FLOPS * 1e3
    for key, times in results.items():
        best = min(times)
        print(f"{key}: " + " / ".join(f"{t:.3f}" for t in times)
              + f" ms ({2.0 * n ** 3 / best / 1e9:.1f} TFLOP/s, "
              f"{100 * bound / best:.1f} % of the {bound:.3f} ms bound)",
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "bound_ms": bound, "ms": results, "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
