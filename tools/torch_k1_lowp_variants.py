#!/usr/bin/env python3
"""Time design variants of K1's low-precision kernel on one CUDA card.

    python3 tools/torch_k1_lowp_variants.py [--reps 5] [--rounds 2]

Each variant is the committed `bof_tpu_torch/csrc/matmul_lowp.cu` with a
few textual edits (`_variants` below), built with nvcc for sm_90a into its own
library under the port's build root, beside the committed source built the
same way.  At the pipeline's superblock (8192^3), for bf16 and int8, each
library runs `bof_accum_matmul_lowp` with B stored (N, K) (nothing packed)
and with B stored (K, N) (B packed by the pack pass); every variant but
'no_c_store' must give the committed build's bits.  Times are the median
of `--reps` CUDA-event samples, taken in `--rounds` rounds that alternate
the variants' order, beside the library call (torch.mm with an fp32
output, torch._int_mm on B stored (N, K)).  Prints the card's name and
power limit, what ptxas notes of each build, one line a measurement and
one JSON line.  Needs a card and nvcc; exits 2 without them.
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
MARK_EPI = "  // a thread's two columns of a chunk are adjacent"
MARK_END = ("\n}\n\n// -------------------------------------------------"
            "----------------- host")

# the epilogue as first written: one load, one update and one store an
# element, in turn
SERIAL_EPILOGUE = """#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= M) continue;
    Out* drow = d + (long long)row * ldd;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + e;
        if (col < N)
          drow[col] = epilogue(alpha, acc[4 * j + 2 * i + e], drow[col]);
      }
    }
  }"""

WAIT_WITHOUT_WATCHDOG = """using namespace hopper;

__device__ __forceinline__ void mbar_spin(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\\n.reg .pred p;\\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
        "selp.u32 %0, 1, 0, p;\\n}\\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
"""


def _variants(src: str) -> dict:
    """name -> source; each edit must find its text exactly once."""
    def edit(text, *pairs):
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(
                    f"variant edit does not apply: {old[:60]!r}")
            text = text.replace(old, new)
        return text
    start, end = src.index(MARK_EPI), src.index(MARK_END)
    return {
        "committed": src,
        # C read but not written (a store only where a sum is a sentinel
        # no input gives): the mainloop and C's reads
        "no_c_store": edit(src, (
            "        if (pairs && col + 1 < N) {\n          P2 v;\n",
            "        if (v0 == Out(-12345)) {\n          P2 v;\n"), (
            "          *reinterpret_cast<P2*>(drow + col) = v;\n"
            "        } else {",
            "          *reinterpret_cast<P2*>(drow + col) = v;\n"
            "        } else if (v1 == Out(-12345)) {")),
        "serial_epilogue": src[:start] + SERIAL_EPILOGUE + src[end:],
        "epi_chunks_16": edit(src, ("constexpr int EPI_CHUNKS = 8;",
                                    "constexpr int EPI_CHUNKS = 16;")),
        "wait_without_watchdog": edit(
            src, ("using namespace hopper;\n", WAIT_WITHOUT_WATCHDOG),
            ("    mbar_wait(full + 8 * s, (kt / STAGES) & 1);",
             "    mbar_spin(full + 8 * s, (kt / STAGES) & 1);")),
    }


def _build(variants: dict, root: str) -> dict:
    """One nvcc a variant, all at once; name -> (CDLL, ptxas notes)."""
    from bof_tpu_torch.ops import cuda_lib
    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, text in variants.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "matmul_lowp.cu"), "w") as f:
            f.write(text)
        shutil.copy(os.path.join(CSRC, "hopper.cuh"), d)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_lib.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "matmul_lowp.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        fn = lib.bof_accum_matmul_lowp
        fn.argtypes = cuda_lib._ENTRIES["bof_accum_matmul_lowp"]
        fn.restype = ctypes.c_int
        notes = [line.split("info    :")[-1].strip() for line in
                 log.splitlines() if "C75" in line or (
                     "registers" in line and "barriers" in line)]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bof_tpu_torch.io.native import build_root
    from bof_tpu_torch.ops.matmul_cuda import k1_ldw
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with open(os.path.join(CSRC, "matmul_lowp.cu")) as f:
        variants = _variants(f.read())
    libs = _build(variants, os.path.join(build_root(), "k1_lowp_variants"))
    for name, (_, notes) in libs.items():
        print(f"{name}: ptxas {'; '.join(notes)}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    stream = torch.cuda.current_stream(dev).cuda_stream
    m = n = k = 8192
    results = {}
    for kind, dtype in ((0, torch.bfloat16), (1, torch.int8)):
        tag = "bf16" if kind == 0 else "s8"
        if dtype == torch.int8:
            a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                              dtype=dtype)
            b_nk = torch.randint(-127, 128, (n, k), generator=gen,
                                 device=dev, dtype=dtype)
        else:
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b_nk = torch.randn((n, k), generator=gen, device=dev).to(dtype)
        b_kn = b_nk.T.contiguous()
        c0 = torch.randn((m, n), generator=gen, device=dev)
        ldw = k1_ldw(k, a.element_size())
        ws = torch.empty((n, ldw), dtype=dtype, device=dev)

        def call(fn, c, packed):
            b = b_kn if packed else b_nk
            rc = fn(c.data_ptr(), a.data_ptr(), b.data_ptr(), 1e-3, m, n, k,
                    0, int(not packed), 0, k, b.shape[1], n, kind,
                    None, ws.data_ptr() if packed else None, ldw, stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        for packed in (False, True):
            want = None
            for name, (fn, _) in libs.items():
                c = c0.clone()
                call(fn, c, packed)
                torch.cuda.synchronize()
                if name == "committed":
                    want = c
                elif name != "no_c_store" and not torch.equal(c, want):
                    raise AssertionError(f"{tag} {name}: not the committed "
                                         "kernel's bits")
            del want
            names = list(libs)
            for r in range(args.rounds):
                for name in (names if r % 2 == 0 else names[::-1]):
                    fn = libs[name][0]
                    c = c0.clone()
                    key = f"{tag} {'B packed' if packed else 'B (N,K)'} {name}"
                    results.setdefault(key, []).append(_median_ms(
                        lambda: call(fn, c, packed), args.reps))
        if dtype == torch.int8:
            lib = lambda: torch._int_mm(a, b_nk.T)
            what = "torch._int_mm(A, B stored (N, K))"
        else:
            lib = lambda: torch.mm(a, b_kn, out_dtype=torch.float32)
            what = "torch.mm(bf16, bf16, out_dtype=float32)"
        results[f"{tag} library {what}"] = [_median_ms(lib, args.reps)]
        del a, b_nk, b_kn, c0, ws
        torch.cuda.empty_cache()
    for key, times in results.items():
        print(f"{key}: " + " / ".join(f"{t:.4f}" for t in times) + " ms",
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
