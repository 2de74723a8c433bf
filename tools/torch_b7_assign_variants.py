#!/usr/bin/env python3
"""Time design variants of B7's assign kernel on one CUDA card.

    python3 tools/torch_b7_assign_variants.py [--reps 5] [--rounds 2]
        [--only a,b] [--first-design FILE]

Each variant is `bof_tpu_torch/csrc/kmeans.cu` with a few textual edits
(`_variants` below: the center tile's width; 16 floats of K a stage, so a
fresh tensor-core accumulator a 16-deep slice, twice the fp32 adds and a
4-stage ring; accumulators that start at 0, with each distance formed
from |c|^2 in the fold, as first built; and, for timing only, a fold
that does nothing), or the kernel's first design, the FFMA tile with
an argmin epilogue (FILE, else `git show` of it from commit 2359845),
each compiled by nvcc for sm_90a, with the committed `hopper.cuh`, into
its own library under the port's build root, all at once.
At S11's streamed block (bn 131072, d 128, k 1024) and at a ragged
65537 x 130 x 1000 (the split pass's padded copy), each runs
`bof_lloyd_assign` on seeded blob points: the variants that keep the
committed arithmetic (the tile width) must give its bits, and
every variant's labels must equal
the plain version's (`lloyd_assign_ref`) but at float64 near-ties, with
mind within 1e-5 * (|p|^2 + max|c|^2) ('no_fold' is exempt: it
computes no labels).  Times are the median of `--reps`
CUDA-event samples of one call (the split pass included), taken in
`--rounds` rounds that alternate the variants' order, beside the plain
version, the torch.addmm + torch.min pair and the bound (three TF32
passes of 2 * bn * k * d operations at 495 TFLOP/s).  Prints the card's
name and power limit, what ptxas notes of each build, one line a
measurement and one JSON line.  Needs a card and nvcc; exits 2 without
them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join(HERE, "bof_tpu_torch", "csrc")
FIRST_COMMIT = "2359845"  # the FFMA design is this commit's kmeans.cu
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor cores, FLOP/s (data sheet)
FIRST = "ffma_first_design"
SHAPES = ((131072, 128, 1024), (65537, 130, 1000))
NAMES = ("committed", "tile_128", "bk16", "cn_in_fold", "no_fold", FIRST)
TIMING_ONLY = {"no_fold"}
# variants whose arithmetic is the committed one's, so must give its bits
SAME_BITS = {"committed", "tile_128"}
ACC_INIT = """    for (int j = 0; j < A_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * quad + e;
        const float h = col < k ? -0.5f * __ldg(cn + col) : 0.f;
        acc[4 * j + e] = h;
        acc[4 * j + 2 + e] = h;
      }
    }
"""
ZERO_INIT = "    for (int i = 0; i < A_BN / 2; ++i) acc[i] = 0.f;\n"
FOLD_CMP = """            if (acc[4 * j + 2 * i + e] > best_a[i]) {
              best_a[i] = acc[4 * j + 2 * i + e];
"""
# the fold as first built: each distance formed from cn there
CN_FOLD_CMP = """            const float a = acc[4 * j + 2 * i + e] - 0.5f * __ldg(cn + col);
            if (a > best_a[i]) {
              best_a[i] = a;
"""
FOLD_START = "    // fold this tile into the running (max, argmax) of -pd/2, the"
FOLD_END = "  // the 4 lanes of a quad share a row"
# in place of the fold: one add a distance, so the products stay live
NO_FOLD = """    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < A_BN / 2; ++i) sum += acc[i];
    if (sum > best_a[0]) {
      best_a[0] = sum;
      best_j[0] = n0;
    }
  }

"""
# the first design's entry point: (p, cen, cn, labels, mind, bn, k, d,
# stream)
FIRST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]


def _edit(text: str, *pairs) -> str:
    """text with each (old, new) replaced; each old must occur once."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _first_design(path: str) -> str:
    if path:
        with open(path) as f:
            return f.read()
    res = subprocess.run(
        ["git", "-C", HERE, "show",
         f"{FIRST_COMMIT}:bof_tpu_torch/csrc/kmeans.cu"],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError("the first design needs --first-design FILE (git "
                           f"show {FIRST_COMMIT}:bof_tpu_torch/csrc/"
                           f"kmeans.cu) where the repo has no history: "
                           f"{res.stderr.strip()}")
    return res.stdout


def _no_fold(src: str) -> str:
    start, end = src.index(FOLD_START), src.index(FOLD_END)
    return src[:start] + NO_FOLD + src[end:]


def _variants(src: str, names, first_path: str = "") -> dict:
    """name -> source text."""
    make = {
        "committed": lambda: src,
        "tile_128": lambda: _edit(src, ("constexpr int A_BN = 256;",
                                        "constexpr int A_BN = 128;")),
        "bk16": lambda: _edit(src, ("constexpr int A_BK = 32;",
                                    "constexpr int A_BK = 16;")),
        "cn_in_fold": lambda: _edit(src, (ACC_INIT, ZERO_INIT),
                                    (FOLD_CMP, CN_FOLD_CMP)),
        "no_fold": lambda: _no_fold(src),
        FIRST: lambda: _first_design(first_path),
    }
    return {name: make[name]() for name in names}


def _build(sources: dict, root: str) -> dict:
    """One nvcc a variant, all at once; name -> (entry point, ptxas notes
    on the assign kernel)."""
    from bof_tpu_torch.ops import cuda_lib
    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, text in sources.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "kmeans.cu"), "w") as f:
            f.write(text)
        shutil.copy(os.path.join(CSRC, "hopper.cuh"), d)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_lib.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "kmeans.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(root, name, "lib.so")).bof_lloyd_assign
        fn.argtypes = (FIRST_ARGTYPES if name == FIRST else
                       cuda_lib._ENTRIES["bof_lloyd_assign"])
        fn.restype = ctypes.c_int
        notes, entry = [], ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "lloyd_assign_kernel" in entry and (
                    "registers" in line or "spill" in line):
                notes.append(line.split("info    :")[-1].strip())
        libs[name] = (fn, notes)
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


def _near_ties_only(p, c, got, want) -> bool:
    """Where two label vectors differ, the two centers' float64 partial
    distances are within 1e-5 * (|p|^2 + max|c|^2) of each other."""
    import torch
    diff = (got != want).nonzero().flatten()
    if diff.numel() == 0:
        return True
    p64, c64 = p[diff].double(), c.double()
    pd = (c64 * c64).sum(1)[None, :] - 2.0 * p64 @ c64.T
    rows = torch.arange(diff.numel(), device=p.device)
    gap = (pd[rows, got[diff].long()] - pd[rows, want[diff].long()]).abs()
    scale = (p64 * p64).sum(1) + float((c64 * c64).sum(1).max())
    return bool((gap <= 1e-5 * scale).all())


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
    from bof_tpu_torch.ops.kmeans import lloyd_assign_ref, lloyd_workspace
    from bof_tpu_torch.ops.matmul_cuda import fp32_workspace, tf32_ldw
    torch.backends.cuda.matmul.allow_tf32 = False
    names = list(NAMES)
    if args.only:
        names = ["committed"] + [n for n in args.only.split(",")
                                 if n != "committed"]
    with open(os.path.join(CSRC, "kmeans.cu")) as f:
        sources = _variants(f.read(), names, args.first_design)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = _build(sources, os.path.join(build_root(), "b7_assign_variants"))
    for name, (_, notes) in libs.items():
        print(f"{name}: ptxas " + "; ".join(notes), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results, checks, bounds = {}, {}, {}
    for bn, d, k in SHAPES:
        shape = f"{bn}x{d}x{k}"
        true = 10.0 * torch.randn((k, d), generator=gen, device=dev)
        lab = torch.randint(0, k, (bn,), generator=gen, device=dev)
        p = true[lab] + torch.randn((bn, d), generator=gen, device=dev)
        c = true + 0.5 * torch.randn((k, d), generator=gen, device=dev)
        cn = (c * c).sum(1)
        ldw = tf32_ldw(d)
        rows = lloyd_workspace(bn, k, d, aligned=(p.data_ptr() % 16 == 0,
                                                  c.data_ptr() % 16 == 0))
        ws, ptr = fp32_workspace(rows, ldw, dev)
        labels = torch.empty(bn, dtype=torch.int32, device=dev)
        mind = torch.empty(bn, dtype=torch.float32, device=dev)

        def call(name):
            fn = libs[name][0]
            head = (p.data_ptr(), c.data_ptr(), cn.data_ptr(),
                    labels.data_ptr(), mind.data_ptr())
            if name == FIRST:
                rc = fn(*head, bn, k, d, stream)
            else:
                rc = fn(*head, ptr.get("p_x"), ptr["p_lo"], ptr.get("c_x"),
                        ptr["c_lo"], ldw, bn, k, d, stream)
            if rc:
                raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

        want_l, want_m = lloyd_assign_ref(p, c, cn)
        scale = (p.double() ** 2).sum(1) + float((c.double() ** 2).sum(1)
                                                 .max())
        committed = None
        for name in libs:
            call(name)
            torch.cuda.synchronize()
            ok = _near_ties_only(p, c, labels, want_l) and bool(
                ((mind - want_m).double().abs() <= 1e-5 * scale).all())
            if name == "committed":
                committed = (labels.clone(), mind.clone())
            same = bool(torch.equal(labels, committed[0])
                        and torch.equal(mind, committed[1]))
            checks[f"{shape} {name}"] = {"agrees_with_plain": ok,
                                         "bits_equal_committed": same}
            print(f"{shape} {name}: labels and mind within the plain "
                  f"version's near-tie rule {ok}; bits equal the committed "
                  f"build's {same}", flush=True)
            if name not in TIMING_ONLY and (
                    not ok or (name in SAME_BITS and not same)):
                raise AssertionError(f"{shape} {name} disagrees")
        order = list(libs)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                results.setdefault(f"{shape} {name}", []).append(
                    _median_ms(lambda: call(name), args.reps))
        results[f"{shape} plain lloyd_assign_ref"] = [
            _median_ms(lambda: lloyd_assign_ref(p, c, cn), args.reps)]
        results[f"{shape} library torch.addmm + torch.min"] = [
            _median_ms(lambda: torch.min(torch.addmm(
                cn[None, :], p, c.T, alpha=-2.0), dim=1), args.reps)]
        bounds[shape] = 3 * 2.0 * bn * k * d / TF32_FLOPS * 1e3
        del true, lab, p, c, cn, ws, labels, mind, want_l, want_m, scale
        torch.cuda.empty_cache()
    for key, times in results.items():
        bound = bounds[key.split()[0]]
        print(f"{key}: " + " / ".join(f"{t:.4f}" for t in times)
              + f" ms ({100 * bound / min(times):.1f} % of the {bound:.4f} "
              "ms bound)", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "bound_ms": bounds, "ms": results, "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
