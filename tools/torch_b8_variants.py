#!/usr/bin/env python3
"""Time B8's bodies against each other and against its first design on
one CUDA card.

    python3 tools/torch_b8_variants.py [--reps 7] [--rounds 2]
        [--inner 50] [--first-design FILE]

`bof_tpu_torch/csrc/topk.cu` takes rows of up to TOPK_REG_COLS columns
through its register body (a warp a row, the keys in registers), rows
of up to TOPK_SMEM_COLS through a block a row with the keys in shared
memory ('smem'), and wider rows through the same block re-reading s and
the mask from L2 ('l2').  This builds the committed source, a textual
edit of it that sends every row past the register body to 'l2'
('no_smem'), one whose register body takes each lane's maxima by a tree
over an array of its 32 packed entries instead of one running maximum
('tree_max'), and the first design, a block a row at every width (FILE,
else `git show` of topk.cu from commit 35228ab), each by nvcc for sm_90a
into its own library under the port's build root, all at once.  At the
fused XML step's bands (rows 512 and 2048, lb_max 1024, k 5), at k 64
and k = lb_max 1024, and at 512 x 4096 k 5 (where 'smem' and 'l2'
differ), each runs `bof_row_topk` on seeded normal scores under a -inf
tail of 24 columns; every one must give the plain version's
(`row_topk_ref`) values and columns bit for bit.  Times are the median
of `--reps` CUDA-event samples of `--inner` calls back to back, each
sample queued behind a sleep kernel (so they time the card alone), in
`--rounds` rounds that alternate the variants' order, beside the bound:
the scores and mask read once and k (value, index) pairs a row written,
over 3.35 TB/s.  Prints the card's name and power limit, what ptxas
notes of each build, one line a measurement and one JSON line.  Needs a
card and nvcc; exits 2 without them.
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
CSRC = os.path.join(HERE, "bof_tpu_torch", "csrc")
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s (data sheet)
SHAPES = ((512, 1024, 5), (2048, 1024, 5), (512, 1024, 64),
          (512, 1024, 1024), (512, 4096, 5))
SMEM_BRANCH = "  if (cols <= TOPK_SMEM_COLS)\n"
# 'tree_max': the register body's lane maxima taken over an array of the
# 32 packed entries by a tree of pairwise maxima, in place of one running
# maximum (shorter dependency chains, more registers)
BODY = "// The register body: a warp a row (see the header)."
TREE_FUNCS = """// p[j] = max(p[j], p[j + H]) for j < H (in registers)
template <int H>
__device__ __forceinline__ void fold_half(long long (&p)[TOPK_REG_SLOTS]) {
#pragma unroll
  for (int j = 0; j < H; ++j) p[j] = max64(p[j], p[j + H]);
}

__device__ __forceinline__ long long tree_max(
    long long (&p)[TOPK_REG_SLOTS]) {
  fold_half<16>(p);
  fold_half<8>(p);
  fold_half<4>(p);
  fold_half<2>(p);
  fold_half<1>(p);
  return p[0];
}

"""
FIRST_MAX = """  long long best = LLONG_MIN;  // below every packed entry
#pragma unroll
  for (int j = 0; j < TOPK_REG_SLOTS; ++j)
    best = max64(best, pack(key[j], col_of(j)));
"""
TREE_FIRST_MAX = """  long long p[TOPK_REG_SLOTS];
#pragma unroll
  for (int j = 0; j < TOPK_REG_SLOTS; ++j) p[j] = pack(key[j], col_of(j));
  long long best = tree_max(p);
"""
LOOK_AGAIN = """      const long long w = best;
      best = LLONG_MIN;
#pragma unroll
      for (int j = 0; j < TOPK_REG_SLOTS; ++j) {
        const long long p = pack(key[j], col_of(j));
        if (p < w) best = max64(best, p);
      }
"""
TREE_LOOK_AGAIN = """#pragma unroll
      for (int j = 0; j < TOPK_REG_SLOTS; ++j) {
        const long long e = pack(key[j], col_of(j));
        p[j] = e < best ? e : LLONG_MIN;
      }
      best = tree_max(p);
"""
FIRST_COMMIT = "35228ab"  # the block-a-row design is this commit's
FIRST = "first_design"


def _first_design(path) -> str:
    """The first design's topk.cu: from `path`, else from git."""
    if path:
        with open(path) as f:
            return f.read()
    res = subprocess.run(
        ["git", "-C", HERE, "show",
         f"{FIRST_COMMIT}:bof_tpu_torch/csrc/topk.cu"],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError("the first design needs --first-design FILE (git "
                           f"show {FIRST_COMMIT}:bof_tpu_torch/csrc/topk.cu "
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
            "no_smem": _edit(src, (SMEM_BRANCH, "  if (false)\n")),
            "tree_max": _edit(src, (BODY, TREE_FUNCS + BODY),
                              (FIRST_MAX, TREE_FIRST_MAX),
                              (LOOK_AGAIN, TREE_LOOK_AGAIN)),
            FIRST: _first_design(first_path)}


def _build(sources: dict, root: str) -> dict:
    """One nvcc a variant, all at once; name -> (entry point, ptxas notes
    on the kernel)."""
    from bof_tpu_torch.ops import cuda_lib
    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, text in sources.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "topk.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "topk.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(root, name, "lib.so")).bof_row_topk
        fn.argtypes = cuda_lib._ENTRIES["bof_row_topk"]
        fn.restype = ctypes.c_int
        notes = [line.split("info    :")[-1].strip()
                 for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        libs[name] = (fn, notes)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--inner", type=int, default=50)
    ap.add_argument("--first-design", default=None,
                    help="the first design's source (default: from git)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bof_tpu_torch.io.native import build_root
    from bof_tpu_torch.ops.topk_cuda import row_topk_ref
    with open(os.path.join(CSRC, "topk.cu")) as f:
        sources = _variants(f.read(), args.first_design)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = _build(sources, os.path.join(build_root(), "b8_variants"))
    for name, (_, notes) in libs.items():
        print(f"{name}: ptxas " + "; ".join(notes), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results, bounds = {}, {}
    for rows, cols, k in SHAPES:
        shape = f"{rows}x{cols} k {k}"
        s = torch.randn((rows, cols), generator=gen, device=dev)
        mask = torch.zeros(cols, device=dev)
        mask[cols - 24:] = float("-inf")
        vals = torch.empty((rows, k), device=dev)
        idx = torch.empty((rows, k), dtype=torch.int32, device=dev)

        def call(name):
            rc = libs[name][0](vals.data_ptr(), idx.data_ptr(), s.data_ptr(),
                               mask.data_ptr(), rows, cols, k, stream)
            if rc:
                raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

        want_v, want_i = row_topk_ref(s, mask, k)
        for name in libs:
            vals.zero_()
            idx.zero_()
            call(name)
            torch.cuda.synchronize()
            same = bool(torch.equal(vals.view(torch.int32),
                                    want_v.view(torch.int32))
                        and torch.equal(idx, want_i))
            print(f"{shape} {name}: values and columns bit-identical to the "
                  f"plain version: {same}", flush=True)
            if not same:
                raise AssertionError(f"{shape} {name} disagrees")
        order = list(libs)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                results.setdefault(f"{shape} {name}", []).append(
                    _median_ms(lambda: call(name), args.reps, args.inner))
        bounds[shape] = ((rows * cols + cols) * 4 + rows * k * 8) \
            / HBM_BPS * 1e3
        del s, mask, vals, idx, want_v, want_i
    for key, times in results.items():
        bound = bounds[key.rsplit(" ", 1)[0]]
        print(f"{key}: " + " / ".join(f"{t:.5f}" for t in times)
              + f" ms on the card alone ({100 * bound / min(times):.1f} % "
              f"of the {bound:.5f} ms bound)", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "bound_ms": bounds, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
