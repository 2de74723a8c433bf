#!/usr/bin/env python3
"""Drive bof_tpu_torch's out-of-core SGEMM and sparse paths, in fp32 and
in their link-compressed transfer modes, the paper's three applications,
then its float64 gemm, its out-of-core k-means, sample sort and
map/reduce, and the sharded (mesh) paths, once on one CUDA card.

    python3 chip_smoke.py

Steps, each of which raises (exit code != 0) when it fails:

1. require a CUDA card; print nvidia-smi's name and power limit, the torch
   and CUDA versions and `nvcc --version`;
2. build the kernels from `bof_tpu_torch/csrc` (one nvcc per source, all
   at once) and print the build time and what ptxas reports;
3. kernel K1 (`accum_matmul`): first a probe that wgmma truncates tf32
   operands (what the 3xTF32 split assumes); then both fp32 tiers against
   their plain PyTorch version for all 8 storage layouts, with alpha 1.5
   and a non-zero starting C, at 8192^3, at a ragged 1000x776x516 with
   16-byte rows, at a ragged 1000x777x513 and at 8192x8193x8193 (leading
   dimensions TMA cannot read in place: the split pass copies those
   operands K-major, and the pack count must move by the operands it
   copies): 'highest' (3xTF32) within 2e-4 * max|plain| and 'default' (one
   TF32 pass) within 2e-4 * max|emulation| of its truncating emulation and
   within 2^-10 * sqrt(k) * max|A| * max|B| * |alpha| of full fp32.  At
   8192^3 and at 8192x8193x8193, R/N/N, the median of 5 CUDA-event times
   of each tier, the plain version and `addmm_` with TF32 off (the library
   yardstick) and on; ptxas must report no spills for the tensor-core
   kernel.
   Then K1's transfer-mode variants (one TMA + wgmma kernel body and its
   pack pass) on the 8 layouts at 8192^3 and 1000x776x516 (which packs
   every operand): 'bf16' (bf16 A/B) within 2e-4 * max|plain|, 's8' (int8
   A/B, an exact int32 sum) bit-identical to its plain version, the pack
   count moving by the operands that are MN-major or not 16-byte rows; at
   8192^3 R/N/N each one's time (B packed) beside its time on B packed by
   the plain pack (b_nk, nothing packed: the same bits required), its
   plain version, the library call (torch.mm with an fp32 output;
   torch._int_mm) and the bound; ptxas must report no spills for it;
4. kernel K2 (`spmm_ell`) and the ELL SpMV (`spmv_ell`) against their
   plain versions through the contract csrmm and csrgemv use: each
   row's real slot count (`counts`; about one row in 16 empty, padding
   slots holding va NaN, so a kernel that read one returns NaN), the
   rows permuted (`rows`) into a larger sentinel-filled `out`, and alpha;
   K2 at (a) the csrmm band shape rows 512, rmax 256, k 131072, cb 4096,
   int32 indices; (b) uint16 indices, k 65536, cb 999, rows 24, rmax 64,
   alpha 0.5; (c) a mega-row band rows 8, rmax 16384, cb 256; the SpMV at
   rows 16384, rmax 256, k 131072.  Tolerance on the named rows
   max|kernel - plain| <= 2e-4 * max|plain| + 1e-5 * sqrt(rmax) *
   max|va| * max|B| * |alpha|; every other row must keep the sentinel.
   The SpMV runs 8 such bands, each checked.  K2 at band (a) and the
   SpMV over the 8 bands again on bf16 values and on int8 values with one
   fp32 scale a row (the transfer modes' values), the same way.  At (a),
   and over the 8
   SpMV bands in turn (their ja/va outgrow L2; csrgemv uploads each band
   afresh), the median of 5 samples of back-to-back calls of the kernel
   as csrmm (csrgemv) calls it, of the plain version, and of the same
   band as a torch CSR matrix times B (or x), beside the bound, which
   counts the real slots' ja/va, counts, rows, the dense rows they
   reference and the output once;
5. S1/S2, the gemm main path through `bof_tpu_torch.drivers.gemm.main`:
   32768^3 fp32 order R N/N (alpha 1, beta 0), then 12288^3 (ragged
   superblocks) order C, ta T, tb N, alpha 0.5, beta 2; O_DIRECT, the
   native I/O engine, default blk (8192) and budgets (8 GiB host pin
   cache, 12 GiB device budget);
6. S3, csrmm 'N' at the paper's Fig. 6 shape through
   `bof_tpu_torch.drivers.csrmm.main`: A 2^20 x 2^17 at density 1e-3
   (Poisson 131.072 nnz/row, written by `drivers.sparse_create`), B
   2^17 x 2^12 row-major, C 2^20 x 2^12, alpha 1, beta 0, the library's
   defaults (max_nnzs 2^26, cblk 4096, 12 GiB device budget);
7. S4, csrmm 'T' (csrcsc into scratch, then 'N' with uint16 indices and a
   ragged cb 999): A2 65536 x 262144 at 64 nnz/row, B 65536 x 999 and C
   262144 x 999 column-major, alpha 0.5, beta 2 on a seeded C;
8. S5, csrgemv 'N' (the SpMV kernel) and 'T' (host) on S3's A through
   `bof_tpu_torch.drivers.csrgemv.main`;
8b. the transfer modes, set on the drivers' FlashConfig as bof_tpu's
   bench sets them, each on the files of the fp32 call before it: S6,
   S1's gemm with int8 A/B and a bf16 C download; S7, S2's gemm with bf16
   A/B; S8, S3's csrmm with int8 values and a bf16 C download; S4b, S4's
   csrmm with bf16 values; S9, S5's csrgemv 'N' with bf16 and with int8
   values.  Each must launch only its mode's variant, stay inside
   bof_tpu's band against float64 (max|C - C64| / max|C64| below 2e-2
   for bf16 inputs, 5e-2 for int8, 1e-2 for a bf16 C alone) and above
   1e-6 (it really rounded), and move fewer bytes: gemm's A/B tiles 1/2
   or 1/4 of the fp32 run's `gemm.h2d_bytes`, C's download half its
   `*.d2h_bytes`, csrmm's ELL uploads fewer;
9. after each call, 16 sampled rows and 16 sampled columns of C (the
   whole y for csrgemv) against float64 numpy/scipy with rtol 2e-4 and
   atol 1e-5 * sqrt(inner length) * max|A| * max|B| * |alpha|; each
   kernel's launch count against what the planner forms (K1: mB*nB*kB,
   every one on the mode's variant, and in S6 one operand (B) packed a
   launch, in S7 none;
   K2 and the SpMV: the ELL bands, recomputed here from the offsets with
   fill_row_blocks + ell_row_ranges); for csrmm, that the writer did no
   host assembly (no `csrmm.assemble_s`) and downloaded each row block
   and column panel once (`csrmm.d2h_bytes`); the wall time, GFLOP/s,
   the driver's GB/s, stage seconds and peak device memory.
9b. B8 (`row_topk`, the fused XML step's masked row top-k) against its
   plain version, values and columns bit for bit: the band (rows 512,
   lb_max 1024, k 5; timed beside the plain version, torch.topk and the
   bound), X1's band (rows 2048; timed on the card alone), k 1, k =
   lb_max, all-equal rows, a -inf tail wider than the real labels (the
   register body), lb_max 4096 ('smem') and lb_max 8192 ('l2'); then B10
   (`sort_block`, the sample sort's device block sort) against its plain
   version for every element type it takes (float32, float16, int32,
   uint32, int16, uint16, int8, uint8, bool) at 2^24 and at 1,000,003
   elements with +-0, +-inf, signed NaNs with payloads and duplicates,
   and at 2^24 float32 and uint8 on skewed and ordered inputs (all
   equal, +-0.0 alternating, sorted, reverse sorted, two values
   alternating, all NaNs): bit for bit, two launches bit-identical, the
   input unchanged; at 2^24 float32 timed as a lone call and on the card
   alone (random and all equal, with the histogram's and the passes'
   device time) beside the plain version, torch.sort(stable=True), the
   bound and the one-sweep design's floors (a pass, and all nine reads or
   writes of the block); ptxas must report no spills for either (run
   with the kernel checks of step 4);
9c. the applications, each through its driver, X1 on S3's A and E1 and
   T1 on its first 2^19 documents (a row cut written over spares; cut
   for the time limit): E1, block
   Lanczos (`drivers.eigensolver`, 64 values, 1 restart, one pass):
   K2 launched (forward + transposed bands) x applications times, one
   application to 8 columns of V within rtol 1e-4 of float64 scipy,
   sigma_i^2 within rtol 1e-4 of |A v_i|^2 for the top 8, V orthonormal
   to 1e-5; X1, XML ranking (`drivers.xml_rank`, W 4096 x 2^17 seeded
   normals over a spare's blocks, k 5, fused): K2 and B8 once a band a
   label block, only rows*k*8 bytes down a block, 64 seeded documents
   against float64 dense scores (test_apps.py's _check_topk criteria);
   T1, topic model (`drivers.topic_model`, 1000 topics, proj_dim 64,
   sample rate 0.1, 4 iterations): 16 rows of P = A R within the csrmm
   gate, the full assignment's labels of those rows and of 65536 more
   equal to the plain version's on the same P and centers but at
   near-ties, labels in range, the unnormalized lift float64
   one_hot(labels)^T A within rtol 1e-4, the topic-word matrix that lift
   over its float32 row sums within one rounding, K2 once a projection
   band, B7 launched.  Each
   prints its wall, GFLOP/s (the driver's formula), stage seconds and
   peak device memory.

10. K1 'f64' (DMMA) against its float64 plain version on the 8 layouts
   at 8192^3, 1000x776x516 and 1001x777x517 (there also with leading
   dimensions one wider, odd and even, through the entry point), each
   element within bof_tpu's scaled bound 1e-12 * k * max|A row| *
   max|B col| * |alpha|, two launches bit-identical; B7 (`lloyd_assign`,
   `lloyd_accumulate`) against its plain version at S11's block (bn
   131072, d 128, k 1024), at 1000x33x7, at 65537x130x1000 and at T1's
   sample 104857x64x1000 (labels equal but at float64 near-ties, mind, counts, sums; the assign also
   against its plain 3xTF32 emulation, two launches bit-identical); the
   accumulate also on S11's block
   with all points in one center and with half the centers empty, and at
   100003 points on k 5000, each time bit-equal to its order-faithful
   plain version and bit-identical run to run; each timed beside its
   plain version, its library call(s) and its bound (the accumulate also
   on the card alone); ptxas must report no spills for either;
11. S10, gemm 16384^3 float64 order R N/T, alpha -1.5, beta 0.5, through
   `drivers.gemm --dtype float64`: 8 K1 launches, all 'f64'; 16 rows and
   16 columns against float64 numpy within 1e-12 * (k * max|A row| *
   max|B col| * |alpha| + |beta| * |C0|);
12. S11, `drivers.kmeans` on 2^24 seeded blob points (d 128, k 1024, fp32,
   8 GiB, 3 iterations, --labels-out) streamed through the pin cache:
   B7 launched 128 * 4 times; the labels of 65536 seeded points against
   the float64 argmin to the returned centers (near-ties allowed), the
   inertia against float64 (rtol 1e-4), and one more Lloyd step from the
   returned centers (outside the counted run): the same labels bit for
   bit, exact counts, centers the float64 mean under those labels;
13. S11b, `kmeans_fit` on 2^21 such points resident on the card (one
   upload) and streamed (a host budget below the panel): the same centers
   and labels, 1 and 4 panels over the link;
14. `drivers.gemm_run` on the card for float32 and float64 with
   --ld-pad 5: ALL PASS, every K1 launch on the dtype's variant;
15. S12, `drivers.sort` on 2^29 seeded float32 elements (2 GiB, with +-0,
   +-inf, signed NaNs with payloads and duplicates) with sort_compute
   'device' set on its context: B10 once a phase-1 block (32) and once a
   non-empty phase-3 bucket, the output bit for bit the input's stable
   sort by B10's keys (torch.sort on the card of the regenerated input);
16. S13, `drivers.map_reduce` on 2^29 seeded |N(0, 1)| float32 elements:
   torch.sqrt on the card in 32 blocks, the output np.sqrt of the input
   bit for bit, the sum within rtol 1e-12 of float64 in block order.

S14, the sharded paths (parallel/, the apps' mesh=, the drivers'
--sharded), on a 1 x 1 mesh of one NCCL rank (this card), each right
after the cell whose files and gate it takes, with its kernels and its
collectives (METRICS dist.<name>) counted: `drivers.gemm --sharded` on
S2's files in fp32 (K1 'tf32x3', a reduce-scatter a step) and int8 (the
int32 output of K1 's8', checked bit for bit against its plain version at
8192^3 and 1000x776x516 on the 8 layouts with the transfer-mode kernels,
and timed beside torch._int_mm and the fp32-output 's8'); `drivers.csrmm
--sharded` at Fig. 6 (K2, the same bands); X1 with --sharded (K2 + B8,
two all-gathers a band); on a 2^17-row cut of S3's A, `drivers.eigensolver
--sharded` (two csrmm_sharded passes an application) with the sharded
one-pass operator (all-gather, all-reduce) on 8 columns of V, and
`drivers.topic_model --sharded` (K2, B7, all-reduces), under E1's and
T1's gates; S10 with --sharded from the same C0 (K1 'f64'); and on S11b's
points kmeans_fit_sharded resident and streamed (B7, all-reduces), each
followed by one sharded Lloyd pass under S11's gate.  No collective
crosses cards here: several cards are tested on gloo ranks on the CPU.

S15, on the same world after S13, over spares: `bof_tpu_torch.dryrun.
dryrun_multichip(cards)` in-process (its seven phases, each under the
gate of __graft_entry__.py; K1 tf32x3 and f64, K2 and B7 must launch);
B13's one-rank reduce-scatter (8192 x 8192 fp32) and all-reduce (S11b's
k-means statistics) timed beside their bounds; then kill and resume: a
worker (`chip_smoke.py --resume-worker`) runs a journaled 8192^2 x 8192
fp32 gemm at blk 2048 (16 C superblocks) on the card, a second is
SIGKILLed once its journal holds 4 lines and started again, and its C
must be byte-identical to the first's, with K1 launched (superblocks
left) x 4 times by the resumed run.

Operands are made on the card from seeded generators and written under
`$BOF_SCRATCH`
(default `build/chip_smoke` in this checkout), which must be a real
filesystem (O_DIRECT) with about 40 GiB free.  A phase's big files
become spares when it ends, and the phases after S9 write their files
over a spare's blocks: the card's machine charges every block a run ever
writes (a deleted file's blocks are not given back) against a 45 GiB
disk image, and S1-S9 alone use about 36 GiB of it.  The spares are
deleted at the end.  TF32 is switched off, so every torch matmul here is
full fp32 (but for the one timing that asks for it).
With BOF_SMOKE_PROFILE=1 the S1, S2, S3, E1, X1, T1, S10, S11, S12 and
S13 calls run under torch.profiler and the device time by kernel (and a
launch, for K1, K2, the SpMV, B7, B8 and B10) and the device's busy share
are printed.

The line before the last is the kernel summary as JSON, one entry a
kernel variant the main paths launched (each one's time, plain and
library times, its bound: the larger of its bytes over 3.35 TB/s and its
operations over the peak rate of their type, and its launches in the main
paths); the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
RTOL = 2e-4            # the repo's fp32 tolerance (accumulation order)
ATOL_SCALE = 1e-5      # atol = ATOL_SCALE * sqrt(k) * max|op(A)| * max|op(B)| * |alpha|
N_SAMPLES = 16
ASSIGN_ROWS = 65536  # T1: consecutive rows of P whose labels are checked
CHUNK = 2048           # rows per chunk when streaming operands from disk
MIN_FREE = 40 << 30    # the peak: S3's A (1.65 GB), B (2 GiB) and C
#   (16 GiB) beside the spares of S1 (12 GiB) and S2 (2.25 GiB); S10 and
#   S11 then write over spares (`_retire`, `_reuse`)


def _run(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({res.returncode}): "
                           f"{res.stderr.strip()}")
    return res.stdout.strip()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")


def _median_ms(fn, reps: int = 5, inner: int = 1,
               queued: bool = False) -> float:
    """The median over `reps` samples of one call's time, each sample
    `inner` calls back to back between two CUDA events (so that the host's
    time to launch a short kernel hides behind the one before).  With
    `queued`, each sample is enqueued behind a sleep kernel of about 2 ms,
    so that it times the card's work alone: a call whose launches take the
    host longer than the card takes to run them would time the host."""
    import torch
    fn()  # warm-up (and first-launch costs)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_ms_by_kernel(fn, names, calls: int = 10, tries: int = 3) -> dict:
    """Device time a call of fn spends in each kernel whose name contains
    one of `names` (ms, the mean over `calls` calls under torch.profiler).
    A profile that shows no device time for a named kernel is taken again,
    `tries` times in all; raises if the last still shows none, so that
    only measured times are reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(names)
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            for name in names:
                if name in e.key and us > 0:
                    out[name] = (out[name] or 0.0) + us / calls / 1e3
        missing = [name for name, ms in out.items() if ms is None]
        if not missing:
            return out
        print(f"torch.profiler shows no device time for {missing}; "
              "profiling again", flush=True)
    raise AssertionError(f"torch.profiler shows no device time for "
                         f"{missing} in {tries} profiles")


HBM_BPS = 3.35e12      # H100 SXM device memory, bytes/s (data sheet)
TF32_FLOPS = 495e12    # H100 SXM dense TF32 tensor cores, FLOP/s
FP32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores, FLOP/s
BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores, FLOP/s
INT8_OPS = 1979e12     # H100 SXM dense int8 tensor cores, OP/s
FP64_FLOPS = 67e12     # H100 SXM fp64 tensor cores (DMMA), FLOP/s
# bof_tpu's bands against float64 for each transfer mode (tests/test_gemm.py
# :112, :202, :135): max|C - C64| / max|C64| below the band (and above
# FLOOR, so that the mode is seen to round)
BANDS = {("bfloat16", "float32"): 2e-2, ("int8", "float32"): 5e-2,
         ("float32", "bfloat16"): 1e-2, ("int8", "bfloat16"): 5e-2}
FLOOR = 1e-6
# K1's variant for each transfer_dtype at 'highest'; the ELL kernels' for
# each value type
K1_OF = {"float32": "tf32x3", "bfloat16": "bf16", "int8": "s8"}
ELL_OF = {"float32": "f32", "bfloat16": "bf16", "int8": "s8"}


def _bound(nbytes, flops, peak):
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger (ms, which)."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _k1_check(label, got, want, limit, limit_desc) -> float:
    err = float((got - want).abs().max())
    ok = err <= limit
    print(f"K1 {label}: max|kernel-plain| {err:.6g} (limit {limit:.6g} = "
          f"{limit_desc}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {label}")
    return err


def _tf32_probe(dev) -> None:
    """wgmma's TF32 conversion, which the 3xTF32 split assumes is
    truncation: with A = I one 'default' pass returns op(B) as converted."""
    import numpy as np
    import torch
    from bof_tpu_torch.ops.matmul_cuda import accum_matmul, tf32_truncate
    b = torch.from_numpy(np.random.default_rng([SEED, 1]).standard_normal(
        (128, 128), dtype=np.float32)).to(dev)
    c = torch.zeros_like(b)
    accum_matmul(c, torch.eye(128, device=dev), b, 1.0, a_km=False,
                 b_nk=False, c_nm=False, prec="default")
    torch.cuda.synchronize()
    truncated = bool(torch.equal(c, tf32_truncate(b)))
    print(f"K1 probe: wgmma {'truncates' if truncated else 'does NOT truncate'}"
          " tf32 operands (A = I, one pass: C == truncate(B) "
          f"{truncated}, C == B {bool(torch.equal(c, b))})", flush=True)
    if not truncated:
        raise AssertionError("the 3xTF32 split assumes truncation")


def kernel_phase(dev) -> dict:
    """K1 against its plain versions on the card, every fp32 tier and
    layout; times at 8192^3 and at leading dimension 8193; returns the
    summary."""
    import itertools

    import numpy as np
    import torch
    from bof_tpu_torch.ops.matmul_cuda import (accum_matmul,
                                               accum_matmul_ref,
                                               accum_matmul_tf32_ref,
                                               k1_packs, k1_variant)

    _tf32_probe(dev)
    rng = np.random.default_rng(SEED)
    alpha = 1.5
    worst = worst_default = 0.0
    timing = {}
    # the main path's superblock, a ragged shape with 16-byte rows, a
    # ragged shape whose rows TMA cannot read in place (odd leading
    # dimensions: the split pass copies both operands), and the f64
    # phase's timed leading dimension 8193 at full size; each at 'highest'
    # and 'default', timed at R/N/N where the key is set
    cases = (((8192, 8192, 8192), ""), ((1000, 776, 516), None),
             ((1000, 777, 513), None), ((8192, 8193, 8193), "_ld8193"))
    for (m, n, k), tkey in cases:
        a_log = torch.from_numpy(
            rng.standard_normal((m, k), dtype=np.float32)).to(dev)
        b_log = torch.from_numpy(
            rng.standard_normal((k, n), dtype=np.float32)).to(dev)
        c_log = torch.from_numpy(
            rng.standard_normal((m, n), dtype=np.float32)).to(dev)
        for (a_km, b_nk, c_nm), prec in itertools.product(
                itertools.product((False, True), repeat=3),
                ("highest", "default")):
            a = a_log.T.contiguous() if a_km else a_log
            b = b_log.T.contiguous() if b_nk else b_log
            c0 = c_log.T.contiguous() if c_nm else c_log
            flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
            variant = k1_variant(prec)
            if variant != ("tf32x3" if prec == "highest" else "tf32"):
                raise AssertionError(f"k1_variant chose {variant} at "
                                     f"{m}x{n}x{k} {flags} {prec}")
            packs = sum(k1_packs(a_km, b_nk, a.shape[1], b.shape[1],
                                 torch.float32))
            before = (accum_matmul.variant_launches[variant],
                      accum_matmul.tf32_packs)
            got = accum_matmul(c0.clone(), a, b, alpha, prec=prec, **flags)
            want = accum_matmul_ref(c0.clone(), a, b, alpha, **flags)
            torch.cuda.synchronize()
            if (accum_matmul.variant_launches[variant],
                    accum_matmul.tf32_packs) != (before[0] + 1,
                                                 before[1] + packs):
                raise AssertionError(f"the {variant} count or its {packs} "
                                     "split-pass copies did not move")
            label = (f"{variant} {m}x{n}x{k} a_km={int(a_km)} "
                     f"b_nk={int(b_nk)} c_nm={int(c_nm)} ({packs} copied "
                     "K-major)")
            scale = float(want.abs().max())
            if prec == "highest":
                worst = max(worst, _k1_check(label, got, want, RTOL * scale,
                                             f"{RTOL}*max|plain|"))
            else:
                emul = accum_matmul_tf32_ref(c0.clone(), a, b, alpha,
                                             **flags)
                _k1_check(label + " vs one-pass emulation", got, emul,
                          RTOL * float(emul.abs().max()),
                          f"{RTOL}*max|emulation|")
                del emul
                limit = 2.0 ** -10 * k ** 0.5 * float(a.abs().max()) \
                    * float(b.abs().max()) * abs(alpha)
                worst_default = max(worst_default, _k1_check(
                    label + " vs full fp32", got, want, limit,
                    "2^-10*sqrt(k)*max|A|*max|B|*|alpha|"))
            if tkey is not None and not (a_km or b_nk or c_nm):
                c_t = c0.clone()
                key = "ms" if prec == "highest" else "ms_default"
                timing[key + tkey] = _median_ms(lambda: accum_matmul(
                    c_t, a, b, alpha, prec=prec, **flags))
                if prec == "highest":
                    timing["plain_ms" + tkey] = _median_ms(
                        lambda: accum_matmul_ref(c_t, a, b, alpha, **flags))
                    timing["library_ms" + tkey] = _median_ms(
                        lambda: c_t.addmm_(a, b, alpha=alpha))
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        timing["library_tf32_ms" + tkey] = _median_ms(
                            lambda: c_t.addmm_(a, b, alpha=alpha))
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
                del c_t
            del got, want
        del a_log, b_log, c_log
        torch.cuda.empty_cache()
    out = {"max_abs_err": worst, "max_abs_err_default": worst_default}
    for (m, n, k), tkey in cases:
        if tkey is None:
            continue
        flop = 2.0 * m * n * k
        nbytes = 4 * (m * k + k * n + 2 * m * n)
        bound, by = _bound(nbytes, 3 * flop, TF32_FLOPS)
        out["bound_ms" + tkey], out["bound_by" + tkey] = bound, by
        out["bound_default_ms" + tkey] = _bound(nbytes, flop, TF32_FLOPS)[0]
        print(f"K1 {m}x{n}x{k} R/N/N (leading dimensions {k}/{n}), median "
              "of 5 CUDA-event times: " + ", ".join(
                  f"{key} {timing[key + tkey]:.3f} ms "
                  f"({flop / timing[key + tkey] / 1e9:.1f} TFLOP/s)"
                  for key in ("ms", "ms_default", "plain_ms", "library_ms",
                              "library_tf32_ms"))
              + f"; 3xTF32 bound {bound:.3f} ms ({by}), the kernel at "
              f"{100 * bound / timing['ms' + tkey]:.1f} % of it and "
              f"{timing['ms' + tkey] / timing['library_ms' + tkey]:.2f}x "
              "addmm_ (TF32 off); one-pass bound "
              f"{out['bound_default_ms' + tkey]:.3f} ms", flush=True)
    return {**out, **timing}


def _lowp_library(a, b, kind):
    """One PyTorch call for the same product on the same operands, as the
    yardstick: (fn, what it is).  bf16: torch.mm with an fp32 output;
    int8: torch._int_mm (int32 out) on B stored (N, K), the K-major
    layout K1 takes with b_nk and cuBLASLt's int8 kernels take directly
    (with B row-major it takes a much slower path)."""
    import torch
    if kind == "bf16":
        return (lambda: torch.mm(a, b, out_dtype=torch.float32),
                "torch.mm(bf16, bf16, out_dtype=float32)")
    b_nk = b.T.contiguous().T
    return (lambda: torch._int_mm(a, b_nk),
            "torch._int_mm(A, B stored (N, K))")


def lowp_kernel_phase(dev) -> dict:
    """K1's transfer-mode variants against their plain versions on the
    card, every layout, at 8192^3 and a ragged 1000x776x516: 'bf16' within
    2e-4 * max|plain| (exact products, another summation order), 's8' bit
    for bit (an exact int32 sum, then the same two fp32 roundings), and
    the pack count moving by the operands that are MN-major or whose rows
    are not 16-byte multiples.  At 8192^3 R/N/N the median of 5
    CUDA-event times of the kernel (B packed: S6's layout), of the kernel
    on B packed by `pack_kmajor_ref` (b_nk, nothing packed: the library
    call's layout; the same bits required), of its plain version and of
    the library call, and the bound."""
    import itertools

    import numpy as np
    import torch
    from bof_tpu_torch.ops.matmul_cuda import (accum_matmul,
                                               accum_matmul_ref, k1_variant,
                                               pack_kmajor_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    out = {}
    for kind, dtype in (("bf16", torch.bfloat16), ("s8", torch.int8)):
        worst, timing = 0.0, {}
        # s8's alpha is gemm's scale alpha * s_a * s_b: max|x| / 127 each
        alpha = 1.5 if kind == "bf16" else 1.5 * (4.5 / 127) ** 2
        for m, n, k in ((8192, 8192, 8192), (1000, 776, 516)):
            def operand(shape):
                if kind == "s8":
                    return torch.randint(-127, 128, shape, generator=gen,
                                         device=dev, dtype=torch.int8)
                return torch.randn(shape, generator=gen,
                                   device=dev).to(torch.bfloat16)
            a_log, b_log = operand((m, k)), operand((k, n))
            c_log = torch.randn((m, n), generator=gen, device=dev)
            for a_km, b_nk, c_nm in itertools.product((False, True),
                                                      repeat=3):
                a = a_log.T.contiguous() if a_km else a_log
                b = b_log.T.contiguous() if b_nk else b_log
                c0 = c_log.T.contiguous() if c_nm else c_log
                flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
                if k1_variant("highest", dtype=dtype) != kind:
                    raise AssertionError(f"k1_variant did not choose {kind}")
                before = accum_matmul.variant_launches[kind]
                packs = accum_matmul.lowp_packs
                got = accum_matmul(c0.clone(), a, b, alpha, **flags)
                want = accum_matmul_ref(c0.clone(), a, b, alpha, **flags)
                torch.cuda.synchronize()
                if accum_matmul.variant_launches[kind] != before + 1:
                    raise AssertionError(f"the {kind} count did not move")
                # an operand is packed when MN-major or its rows are not a
                # multiple of 16 bytes apart (1000x776x516: all of them)
                elem = a.element_size()
                want_packs = int(a_km or a.shape[1] * elem % 16 != 0) \
                    + int(not b_nk or b.shape[1] * elem % 16 != 0)
                if accum_matmul.lowp_packs - packs != want_packs:
                    raise AssertionError(
                        f"{kind} {m}x{n}x{k} {flags}: packed "
                        f"{accum_matmul.lowp_packs - packs} operands, "
                        f"expected {want_packs}")
                label = (f"{kind} {m}x{n}x{k} a_km={int(a_km)} "
                         f"b_nk={int(b_nk)} c_nm={int(c_nm)} "
                         f"({want_packs} packed)")
                if kind == "s8":
                    err = float((got - want).abs().max())
                    same = bool(torch.equal(got, want))
                    print(f"K1 {label}: bit-identical to the plain version "
                          f"{same} (max|kernel-plain| {err:.6g}) "
                          f"{'ok' if same else 'FAIL'}", flush=True)
                    if not same:
                        raise AssertionError(f"K1 {label} is not bit-"
                                             "identical to its plain version")
                else:
                    err = _k1_check(label, got, want,
                                    RTOL * float(want.abs().max()),
                                    f"{RTOL}*max|plain|")
                worst = max(worst, err)
                del got, want
                if m == 8192 and not (a_km or b_nk or c_nm):
                    c_t = c0.clone()
                    timing["ms"] = _median_ms(lambda: accum_matmul(
                        c_t, a, b, alpha, **flags))
                    timing["plain_ms"] = _median_ms(lambda: accum_matmul_ref(
                        c_t, a, b, alpha, **flags))
                    lib, what = _lowp_library(a, b, kind)
                    timing["library_ms"] = _median_ms(lib)
                    timing["library"] = what
                    # B packed K-major by the plain pack: the product reads
                    # it in place (nothing packed) and must give the bits
                    # the kernel's own pack pass gave
                    b_k = pack_kmajor_ref(b, mn_major=True, ld=k)
                    packs = accum_matmul.lowp_packs
                    got = accum_matmul(c0.clone(), a, b, alpha, **flags)
                    got_k = accum_matmul(c0.clone(), a, b_k, alpha,
                                         a_km=False, b_nk=True, c_nm=False)
                    torch.cuda.synchronize()
                    if accum_matmul.lowp_packs - packs != 1 or \
                            not torch.equal(got, got_k):
                        raise AssertionError(
                            f"K1 {kind}: the pack pass is not its plain "
                            "version (or packed where it should not)")
                    timing["ms_b_nk"] = _median_ms(lambda: accum_matmul(
                        c_t, a, b_k, alpha, a_km=False, b_nk=True,
                        c_nm=False))
                    del c_t, lib, b_k, got, got_k
            del a_log, b_log, c_log, a, b, c0
            torch.cuda.empty_cache()
        n3 = 8192 ** 2
        elem = 2 if kind == "bf16" else 1
        bound, by = _bound(2 * n3 * elem + 2 * n3 * 4, 2.0 * 8192 ** 3,
                           BF16_FLOPS if kind == "bf16" else INT8_OPS)
        print(f"K1 {kind} 8192^3 canonical, median of 5 CUDA-event times: "
              f"kernel {timing['ms']:.3f} ms (B packed; on B stored (N, K), "
              f"nothing packed: {timing['ms_b_nk']:.3f} ms, the pack pass "
              f"{timing['ms'] - timing['ms_b_nk']:.3f} ms of it), plain "
              f"{timing['plain_ms']:.3f} ms, library ({timing['library']}) "
              f"{timing['library_ms']:.3f} ms; bound {bound:.3f} ms ({by}), "
              f"the kernel at {100 * bound / timing['ms']:.1f} % of it, "
              f"{100 * bound / timing['ms_b_nk']:.1f} % without the pack",
              flush=True)
        out[f"accum_matmul[{kind}]"] = {"max_abs_err": worst,
                                        "bound_ms": bound, "bound_by": by,
                                        **timing}
    return out


def s8_i32_kernel_phase(dev, s8_ms: float) -> dict:
    """K1 's8' with its int32 output (the sharded int8 step's partial, C +=
    the exact int32 sum) against its plain version bit for bit on the 8
    layouts at 8192^3 and 1000x776x516, from a non-zero int32 C, with the
    pack count per layout.  At 8192^3 R/N/N the median of 5 CUDA-event
    times of the kernel (B packed), of it on B stored (N, K) (nothing
    packed), of the plain version, of torch._int_mm (the same exact product
    into a fresh int32 C, B stored (N, K)) and the bound, beside the
    fp32-output 's8' (`s8_ms`, the phase before)."""
    import itertools

    import torch
    from bof_tpu_torch.ops.matmul_cuda import (accum_matmul,
                                               accum_matmul_s8_ref,
                                               k1_variant)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    if k1_variant("highest", dtype=torch.int8,
                  c_dtype=torch.int32) != "s8_i32":
        raise AssertionError("k1_variant did not choose s8_i32")
    timing, worst = {}, 0
    for m, n, k in ((8192, 8192, 8192), (1000, 776, 516)):
        a_log = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                              dtype=torch.int8)
        b_log = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
        c_log = torch.randint(-1 << 20, 1 << 20, (m, n), generator=gen,
                              device=dev, dtype=torch.int32)
        for a_km, b_nk, c_nm in itertools.product((False, True), repeat=3):
            a = a_log.T.contiguous() if a_km else a_log
            b = b_log.T.contiguous() if b_nk else b_log
            c0 = c_log.T.contiguous() if c_nm else c_log
            flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
            before = accum_matmul.variant_launches["s8_i32"]
            packs = accum_matmul.lowp_packs
            got = accum_matmul(c0.clone(), a, b, 1.0, **flags)
            want = accum_matmul_s8_ref(c0.clone(), a, b, 1.0, **flags)
            torch.cuda.synchronize()
            if accum_matmul.variant_launches["s8_i32"] != before + 1:
                raise AssertionError("the s8_i32 count did not move")
            want_packs = int(a_km or a.shape[1] % 16 != 0) \
                + int(not b_nk or b.shape[1] % 16 != 0)
            if accum_matmul.lowp_packs - packs != want_packs:
                raise AssertionError(f"s8_i32 {m}x{n}x{k} {flags}: packed "
                                     f"{accum_matmul.lowp_packs - packs}, "
                                     f"expected {want_packs}")
            err = int((got - want).abs().max())
            same = bool(torch.equal(got, want))
            print(f"K1 s8_i32 {m}x{n}x{k} a_km={int(a_km)} b_nk={int(b_nk)} "
                  f"c_nm={int(c_nm)} ({want_packs} packed): bit-identical "
                  f"to the plain version {same} (max|kernel-plain| {err}) "
                  f"{'ok' if same else 'FAIL'}", flush=True)
            if not same:
                raise AssertionError("K1 s8_i32 is not bit-identical to its "
                                     "plain version")
            worst = max(worst, err)
            del got, want
            if m == 8192 and not (a_km or b_nk or c_nm):
                c_t = c0.clone()
                timing["ms"] = _median_ms(lambda: accum_matmul(
                    c_t, a, b, 1.0, **flags))
                timing["plain_ms"] = _median_ms(
                    lambda: accum_matmul_s8_ref(c_t, a, b, 1.0, **flags))
                b_nk_t = b.T.contiguous()
                timing["ms_b_nk"] = _median_ms(lambda: accum_matmul(
                    c_t, a, b_nk_t, 1.0, a_km=False, b_nk=True, c_nm=False))
                timing["library_ms"] = _median_ms(
                    lambda: torch._int_mm(a, b_nk_t.T))
                timing["library"] = "torch._int_mm(A, B stored (N, K))"
                del c_t, b_nk_t
        del a_log, b_log, c_log, a, b, c0
        torch.cuda.empty_cache()
    n2 = 8192 ** 2
    bound, by = _bound(2 * n2 + 2 * n2 * 4, 2.0 * 8192 ** 3, INT8_OPS)
    print(f"K1 s8_i32 8192^3 R/N/N, median of 5 CUDA-event times: kernel "
          f"{timing['ms']:.3f} ms (B packed; on B stored (N, K) "
          f"{timing['ms_b_nk']:.3f} ms), the fp32-output s8 {s8_ms:.3f} ms, "
          f"plain {timing['plain_ms']:.3f} ms, library ({timing['library']})"
          f" {timing['library_ms']:.3f} ms; bound {bound:.3f} ms ({by}), "
          f"the kernel at {100 * bound / timing['ms']:.1f} % of it",
          flush=True)
    return {"accum_matmul[s8_i32]": {"max_abs_err": float(worst),
                                     "bound_ms": bound, "bound_by": by,
                                     "s8_fp32_out_ms": s8_ms, **timing}}


def _spare_dir(path):
    return os.path.join(os.path.dirname(path), "spare")


def _retire(path):
    """Keep a finished phase's file as a spare instead of deleting it.  The
    card's machine charges every block a run ever writes against its disk
    image (a deleted file's blocks are not given back), so later phases
    write their files over a spare's blocks (`_reuse`) rather than new
    ones."""
    spare = _spare_dir(path)
    os.makedirs(spare, exist_ok=True)
    os.replace(path, os.path.join(spare, f"{len(os.listdir(spare))}_"
                                         f"{os.path.basename(path)}"))


def _reuse(path, nbytes):
    """Make `path` a file of `nbytes` bytes on the blocks of the smallest
    spare that is large enough (a fresh file if none is); write it with
    open(path, "r+b"), which overwrites in place."""
    spare = _spare_dir(path)
    cands = sorted((os.path.getsize(q), q) for q in (
        os.path.join(spare, f) for f in (os.listdir(spare) if
                                         os.path.isdir(spare) else ()))
        if os.path.getsize(q) >= nbytes)
    if cands:
        os.replace(cands[0][1], path)
    else:
        open(path, "wb").close()
    os.truncate(path, nbytes)


def _write_operand(ctx, path, shape, order, gen, dev):
    """Create `path` through the port's map_array and fill it with
    standard normals made on the card (`gen`), one chunk of storage lines
    at a time; returns max|x|."""
    import numpy as np
    import torch
    import bof_tpu_torch as bt
    arr = bt.map_array(path, shape, np.float32, order, create=True, ctx=ctx)
    lines, width = shape if order == "R" else (shape[1], shape[0])
    amax = 0.0
    for l0 in range(0, lines, CHUNK):
        nl = min(CHUNK, lines - l0)
        x = torch.randn((nl, width), generator=gen, device=dev)
        amax = max(amax, float(x.abs().max()))
        block = x.cpu().numpy()
        if order == "R":
            arr.write_block_storage(l0, 0, nl, width, block)
        else:
            arr.write_block_storage(0, l0, width, nl, block)
    arr.store.flush()
    arr.store.close()
    return amax


def _logical(path, shape, order):
    """Read-only logical (rows, cols) view of a dense file."""
    import numpy as np
    st = tuple(shape) if order == "R" else (shape[1], shape[0])
    mm = np.memmap(path, np.float32, "r", shape=st)
    return mm if order == "R" else mm.T


def _sampled_reference(op_a, op_b, rows, cols):
    """float64 op(A) op(B) on the sampled rows and columns, streaming the
    operands in chunks."""
    import numpy as np
    m, k = op_a.shape
    n = op_b.shape[1]
    a_rows = np.asarray(op_a[rows, :], np.float64)
    want_rows = np.zeros((len(rows), n))
    for k0 in range(0, k, CHUNK):
        want_rows += a_rows[:, k0:k0 + CHUNK] @ np.asarray(
            op_b[k0:k0 + CHUNK, :], np.float64)
    b_cols = np.asarray(op_b[:, cols], np.float64)
    want_cols = np.empty((m, len(cols)))
    for r0 in range(0, m, CHUNK):
        want_cols[r0:r0 + CHUNK] = np.asarray(
            op_a[r0:r0 + CHUNK, :], np.float64) @ b_cols
    return want_rows, want_cols


def _new_ctx(dev, scratch):
    import bof_tpu_torch as bt
    return bt.FlashContext(bt.FlashConfig(
        device=str(dev), io_backend="native", use_o_direct=True,
        scratch_dir=scratch))


def _write_operands(dev, scratch, specs, rng) -> list:
    """Write each (path, shape, order) through the port's map_array, the
    normals made on the card from a seed that `rng` draws; returns max|x|
    of each."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))
    ctx = _new_ctx(dev, scratch)
    try:
        return [_write_operand(ctx, path, shape, order, gen, dev)
                for path, shape, order in specs]
    finally:
        ctx.destroy()


def _reset_launch_counts():
    from bof_tpu_torch.ops import kmeans, matmul_cuda, sort_cuda, topk_cuda
    from bof_tpu_torch.sparse import spmm_cuda
    matmul_cuda.reset_launch_counts()
    spmm_cuda.reset_launch_counts()
    kmeans.reset_launch_counts()
    topk_cuda.reset_launch_counts()
    sort_cuda.reset_launch_counts()


def _launch_counts() -> dict:
    """Every kernel's launch count, each one's by variant as
    '<kernel>[<variant>]', and the operands K1's low-precision pack pass
    rewrote as 'accum_matmul.lowp_packs'."""
    from bof_tpu_torch.ops.kmeans import lloyd_accumulate, lloyd_assign
    from bof_tpu_torch.ops.matmul_cuda import accum_matmul
    from bof_tpu_torch.ops.sort_cuda import sort_block
    from bof_tpu_torch.ops.topk_cuda import row_topk
    from bof_tpu_torch.sparse.spmm_cuda import spmm_ell, spmv_ell
    counts = {"accum_matmul.lowp_packs": accum_matmul.lowp_packs}
    for name, fn in (("accum_matmul", accum_matmul), ("spmm_ell", spmm_ell),
                     ("spmv_ell", spmv_ell), ("lloyd_assign", lloyd_assign),
                     ("lloyd_accumulate", lloyd_accumulate),
                     ("row_topk", row_topk), ("sort_block", sort_block)):
        counts[name] = fn.launches
        counts.update((f"{name}[{v}]", n) for v, n in getattr(
            fn, "variant_launches", {}).items())
    return counts


@contextlib.contextmanager
def _launches_inside(module, name, calls):
    """`module.name` wrapped for the block: each call appends to `calls`
    the kernel launches made inside it (a `_launch_counts` difference), so
    a check can tell the launches of one path's calls from the run's."""
    fn = getattr(module, name)

    def counted(*args, **kw):
        before = _launch_counts()
        try:
            return fn(*args, **kw)
        finally:
            after = _launch_counts()
            calls.append({key: n - before.get(key, 0)
                          for key, n in after.items()})
    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def _configured(driver, **fields):
    """The driver's runs with these FlashConfig fields set on its context,
    as bof_tpu's bench sets the transfer modes (bench.py:2281-2282): the
    drivers have no flag for the modes or for sort_compute."""
    make = driver.make_context

    def with_fields(args):
        ctx = make(args)
        for name, value in fields.items():
            setattr(ctx.config, name, value)
        return ctx
    driver.make_context = with_fields
    try:
        yield
    finally:
        driver.make_context = make


def _drive(dev, fn, argv, profile=False):
    """One call of a driver's main on the main path: every kernel count
    is set to 0 just before it and read just after.  Returns (wall s,
    launches by kernel, METRICS snapshot, peak device bytes)."""
    import torch
    from bof_tpu_torch.utils import METRICS
    _reset_launch_counts()
    METRICS.reset()
    torch.cuda.init()  # the allocator's statistics exist only after it
    torch.cuda.reset_peak_memory_stats(dev)
    if profile:
        wall = _profiled(fn, argv)
    else:
        wall = fn(argv)
    launches = _launch_counts()
    return (wall, launches, METRICS.snapshot(),
            torch.cuda.max_memory_allocated(dev))


def _profiled(fn, argv) -> float:
    """fn(argv) under torch.profiler: prints device time by kernel and the
    device's busy share of the wall (one stream, so device events do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = fn(argv)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, memcpys): the CPU ops that launch
    # them would count the same time again
    rows = sorted(((dev_us(e), e.count, e.key) for e in events
                   if str(e.device_type).endswith("CUDA")
                   and dev_us(e) > 0), reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e6
    print(f"[profile] device busy {busy:.3f} s of wall {wall:.3f} s: idle "
          f"{100 * (1 - busy / wall):.1f} %", flush=True)
    for us, count, key in rows[:8]:
        print(f"[profile] {us / 1e6:9.3f} s  {count:6d}x  {key[:90]}",
              flush=True)
    for name in ("accum_tf32_kernel", "accum_lowp_kernel", "pack_kernel",
                 "spmm_ell_kernel", "spmv_ell_kernel", "accum_dgemm_kernel",
                 "lloyd_assign_kernel", "row_topk_kernel",
                 "row_topk_reg_kernel") + ACC_KERNELS + SORT_KERNELS:
        hits = [(us, count) for us, count, key in rows if name in key]
        if hits:
            us = sum(h[0] for h in hits)
            count = sum(h[1] for h in hits)
            print(f"[profile] {name}: {us / 1e3:.3f} ms device time over "
                  f"{count} launches, {us / 1e3 / count:.4f} ms a launch",
                  flush=True)
    return wall


def _verify(label, pairs, atol, atol_desc) -> float:
    """Every (got, want) pair within rtol * |want| + atol; returns the
    max abs error."""
    import numpy as np
    worst = max_err = 0.0
    for got, want in pairs:
        if not np.isfinite(got).all():
            raise AssertionError(f"[{label}] non-finite values in the output")
        excess = np.abs(got - want) / (RTOL * np.abs(want) + atol)
        worst = max(worst, float(excess.max()))
        max_err = max(max_err, float(np.abs(got - want).max()))
    print(f"[{label}] max abs err {max_err:.6g}, worst err/(rtol*|ref| + "
          f"atol) {worst:.4f} (rtol {RTOL}, atol {atol:.6g} = "
          f"{atol_desc})", flush=True)
    if worst > 1.0:
        raise AssertionError(f"[{label}] disagrees with the float64 "
                             "reference")
    return max_err


def _verify_band(label, pairs, band) -> float:
    """A transfer mode's run against float64: max|got - want| over
    max|want| (all pairs) inside bof_tpu's band and above FLOOR (the mode
    really rounded); returns that relative error."""
    import numpy as np
    for got, _ in pairs:
        if not np.isfinite(got).all():
            raise AssertionError(f"[{label}] non-finite values in the output")
    err = max(float(np.abs(got - want).max()) for got, want in pairs)
    rel = err / max(float(np.abs(want).max()) for _, want in pairs)
    ok = FLOOR < rel < band
    print(f"[{label}] max|C - C64| / max|C64| {rel:.6g} (bof_tpu's band "
          f"{band}; above {FLOOR}: the inputs or C really rounded) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{label}] outside the transfer mode's band")
    return rel


def _check_launches(label, launches, want):
    """Each kernel ran exactly as often as the planner says (0 for the
    kernels this path does not use)."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"[{label}] {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    if not any(launches.values()):
        raise AssertionError(f"[{label}] no kernel launched")


def _check_collectives(label, stages, want):
    """The sharded path's collectives (counted in METRICS as dist.<name>)
    ran: each as often as `want` gives, None for at least once."""
    got = {name: int(stages.get(f"dist.{name}", 0)) for name in want}
    print(f"[{label}] collectives: " + ", ".join(
        f"{name} {n}" for name, n in got.items()), flush=True)
    for name, n in got.items():
        if n == 0 or (want[name] is not None and n != want[name]):
            raise AssertionError(f"[{label}] {name} ran {n} times, "
                                 f"expected {want[name] or 'some'}")


def _stages(label, snap, prefix, keys):
    print(f"[{label}] stage seconds (summed per thread): " + ", ".join(
        f"{key}={snap.get(prefix + key, 0.0):.3f}" for key in keys),
        flush=True)


def gemm_phase(dev, scratch, m, n, k, order, ta, tb, alpha, beta,
               modes) -> list:
    """One gemm shape through the driver, once for each (label,
    transfer_dtype, c_transfer_dtype[, sharded]) of `modes` on the same A
    and B files and the same starting C, the first in fp32.  A sharded
    mode runs `drivers.gemm --sharded` (gemm_sharded on a 1 x 1 mesh of
    one NCCL rank: K1 into a zeroed partial, a reduce-scatter over 'y',
    then C += alpha * the sum; the int8 mode on K1 's8''s int32 output)
    under the same gate, with its reduce-scatters counted.  Returns each
    run's launches."""
    import numpy as np
    import bof_tpu_torch as bt
    from bof_tpu_torch.drivers import gemm as gemm_driver
    from bof_tpu_torch.utils import cdiv

    shape = f"gemm {m}x{n}x{k} order={order} ta={ta} tb={tb} " \
            f"alpha={alpha} beta={beta}"
    rng = np.random.default_rng([SEED, m, n, k])
    paths = {x: os.path.join(scratch, f"{x}_{m}_{n}_{k}.bin") for x in "ABC"}
    c0_path = paths["C"] + ".0"
    a_shape = (k, m) if ta == "T" else (m, k)
    b_shape = (n, k) if tb == "T" else (k, n)
    t0 = time.perf_counter()
    specs = [(paths["A"], a_shape, order), (paths["B"], b_shape, order)]
    if beta != 0.0:
        specs.append((paths["C"], (m, n), order))
    a_max, b_max = _write_operands(dev, scratch, specs, rng)[:2]
    rows = np.sort(rng.choice(m, N_SAMPLES, replace=False))
    cols = np.sort(rng.choice(n, N_SAMPLES, replace=False))
    c0_rows = c0_cols = 0.0
    if beta != 0.0:
        c0 = _logical(paths["C"], (m, n), order)
        c0_rows = np.asarray(c0[rows, :], np.float64)
        c0_cols = np.asarray(c0[:, cols], np.float64)
        del c0
        shutil.copyfile(paths["C"], c0_path)  # each mode starts from C0
    print(f"[{shape}] operands written in {time.perf_counter() - t0:.1f} s",
          flush=True)

    blk = bt.FlashConfig().gemm_blk_size
    mB, nB = cdiv(m, blk), cdiv(n, blk)
    steps = mB * nB * cdiv(k, blk)
    # the beta read of C uploads fp32 C blocks in every mode
    c_up = mB * nB * blk * blk * 4 if beta != 0.0 else 0
    # the pipeline's storage layouts (ops/gemm.py:_op_block_reader): the
    # low-precision variants pack an MN-major operand each launch (the
    # tiles' rows, blk elements, are 16-byte multiples)
    a_km = (order == "C") != (ta == "T")
    b_nk = (order == "C") != (tb == "T")
    runs, want, base = [], None, None
    for tag, xfer, c_xfer, *sharded in modes:
        sharded = bool(sharded and sharded[0])
        label = (f"{tag} {shape} transfer={xfer} c_transfer={c_xfer}"
                 + (" sharded (1x1 NCCL mesh)" if sharded else ""))
        if beta != 0.0 and base is not None:
            shutil.copyfile(c0_path, paths["C"])
        argv = [paths["A"], paths["B"], paths["C"], str(m), str(n), str(k),
                "--order", order, "--ta", ta, "--tb", tb,
                "--alpha", repr(alpha), "--beta", repr(beta), "--o-direct",
                "--io-backend", "native", "--device", str(dev),
                "--scratch", scratch]
        if beta == 0.0:
            argv.append("--create-c")
        if sharded:
            argv.append("--sharded")
        with _configured(gemm_driver, transfer_dtype=xfer,
                         c_transfer_dtype=c_xfer):
            wall, launches, stages, peak = _drive(
                dev, gemm_driver.main, argv,
                profile=(bool(os.environ.get("BOF_SMOKE_PROFILE"))
                         and base is None))
        # every step on the mode's K1 variant: the superblocks are
        # zero-padded to blk (sharded int8: the int32 output)
        variant = "s8_i32" if sharded and xfer == "int8" else K1_OF[xfer]
        packs = steps * (int(a_km) + int(not b_nk)) \
            if variant in ("bf16", "s8", "s8_i32") else 0
        _check_launches(label, launches, {
            "accum_matmul": steps, f"accum_matmul[{variant}]": steps,
            "accum_matmul.lowp_packs": packs})
        flop = 2.0 * m * n * k
        if sharded:
            _check_collectives(label, stages, {"reduce_scatter": steps})
            print(f"[{label}] wall {wall:.3f} s, "
                  f"{flop / wall / 1e9:.1f} GFLOP/s, K1 launches "
                  f"{launches['accum_matmul']} (= mB*nB*kB, all {variant}, "
                  f"{packs} operands packed), peak device memory "
                  f"{peak / 2**30:.2f} GiB, h2d "
                  f"{stages['gemm_sharded.h2d_bytes'] / 2**30:.3f} GiB",
                  flush=True)
            _stages(label, stages, "gemm_sharded.",
                    ("disk_wait_s", "h2d_s", "d2h_s", "write_wait_s"))
        else:
            h2d, d2h = stages["gemm.h2d_bytes"], stages["gemm.d2h_bytes"]
            print(f"[{label}] wall {wall:.3f} s, "
                  f"{flop / wall / 1e9:.1f} GFLOP/s, K1 launches "
                  f"{launches['accum_matmul']} (= mB*nB*kB, all {variant}, "
                  f"{packs} operands packed), peak device memory "
                  f"{peak / 2**30:.2f} GiB, h2d {h2d / 2**30:.3f} GiB, d2h "
                  f"{d2h / 2**30:.3f} GiB", flush=True)
            _stages(label, stages, "gemm.",
                    ("disk_wait_s", "prep_s", "h2d_s", "c_read_s",
                     "tile_wait_s", "accum_wait_s", "d2h_s",
                     "write_wait_s"))
        if base is None and not sharded:
            base = (h2d, d2h)
        elif not sharded:  # (link bytes: the one-card pipeline's metric)
            # the A/B tiles' link bytes shrink with the element, C's with
            # the bf16 download; the same tiles cross as in fp32
            size = {"float32": 4, "bfloat16": 2, "int8": 1}[xfer]
            want_h2d = (base[0] - c_up) * size // 4 + c_up
            want_d2h = base[1] // (2 if c_xfer == "bfloat16" else 1)
            if (h2d, d2h) != (want_h2d, want_d2h):
                raise AssertionError(
                    f"[{label}] link bytes h2d {h2d}, d2h {d2h}; expected "
                    f"{want_h2d}, {want_d2h} from the fp32 run's {base}")
            print(f"[{label}] link bytes: A/B tiles {size}/4 of the fp32 "
                  f"run's, C {'1/2' if c_xfer == 'bfloat16' else 'all'} of "
                  "its download: as expected", flush=True)
        if want is None:
            op_a = _logical(paths["A"], a_shape, order)
            op_b = _logical(paths["B"], b_shape, order)
            op_a = op_a.T if ta == "T" else op_a
            op_b = op_b.T if tb == "T" else op_b
            want_rows, want_cols = _sampled_reference(op_a, op_b, rows, cols)
            want = (alpha * want_rows + beta * c0_rows,
                    alpha * want_cols + beta * c0_cols)
            del op_a, op_b
        c_out = _logical(paths["C"], (m, n), order)
        pairs = [(np.asarray(c_out[rows, :], np.float64), want[0]),
                 (np.asarray(c_out[:, cols], np.float64), want[1])]
        del c_out
        if xfer == c_xfer == "float32":
            _verify(label, pairs, ATOL_SCALE * np.sqrt(k) * a_max * b_max
                    * abs(alpha),
                    f"{ATOL_SCALE}*sqrt(k)*max|A|*max|B|*|alpha|")
        else:
            _verify_band(label, pairs, BANDS[(xfer, c_xfer)])
        runs.append(launches)
    for p in list(paths.values()) + [c0_path]:
        if os.path.exists(p):
            _retire(p)
    return runs


# ------------------------------------------------------------ sparse path

def _ell_tolerance(want, rmax, va_max, b_max, alpha=1.0):
    return RTOL * float(want.abs().max()) + ATOL_SCALE * rmax ** 0.5 \
        * va_max * b_max * abs(alpha)


SENTINEL = -1234.5    # what out holds where a band names no row
K2_INNER = 20         # K2 calls a timing sample (about 0.5 ms each)
SPMV_INNER = 200      # SpMV calls a timing sample (tens of microseconds)
SPMV_BANDS = 8        # SpMV bands timed in turn (about 190 MB of real ja/va)


def _random_ell(rng, rows, rmax, k, idt, fill_lo, dev):
    """An ELL block of `rows` rows: a random count in [fill_lo * rmax,
    rmax] real slots per row, about one row in 16 (at least one) empty,
    and padding slots past the count that hold ja 0 and va NaN, so that a
    kernel that read one would return NaN.  Returns (ja, va, counts,
    max|va| over the real slots)."""
    import numpy as np
    import torch
    counts = rng.integers(int(fill_lo * rmax), rmax + 1, rows)
    counts[rng.choice(rows, max(1, rows // 16), replace=False)] = 0
    ja = rng.integers(0, k, (rows, rmax)).astype(idt)
    va = rng.standard_normal((rows, rmax), dtype=np.float32)
    pad = np.arange(rmax)[None, :] >= counts[:, None]
    ja[pad] = 0
    va[pad] = np.nan
    return (torch.from_numpy(ja).to(dev), torch.from_numpy(va).to(dev),
            torch.from_numpy(counts.astype(np.int32)).to(dev),
            float(np.abs(va[~pad]).max()))


def _placement(rng, rows, width, dev):
    """rows permuted into a larger sentinel-filled out: (rows index, out
    for the kernel, out for the plain version, the untouched rows)."""
    import numpy as np
    import torch
    total = rows + rows // 2 + 3
    perm = rng.permutation(total)
    idx = torch.from_numpy(perm[:rows].astype(np.int32)).to(dev)
    out = torch.full((total,) + width, SENTINEL, device=dev)
    untouched = torch.from_numpy(np.sort(perm[rows:])).to(dev)
    return idx, out, out.clone(), untouched


def _check_placed(label, got, want, untouched, idx, limit) -> float:
    """The named rows within `limit` of the plain version, every other
    row still the sentinel; returns the max abs error."""
    import torch
    err = float((got[idx.long()] - want[idx.long()]).abs().max())
    kept = bool(torch.all(got[untouched] == SENTINEL)) and bool(
        torch.all(want[untouched] == SENTINEL))
    ok = err <= limit and kept
    print(f"{label}: max|kernel-plain| {err:.6g} (limit {limit:.6g} = "
          f"{RTOL}*max|plain| + {ATOL_SCALE}*sqrt(rmax)*max|va|*max|dense|"
          f"*|alpha|), {untouched.numel()} untouched rows keep the "
          f"sentinel: {kept} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def _ell_yardsticks(ja, va, counts, dense, va_scale=None):
    """The bound of an ELL product over `dense` (B, or x) and the same
    band as a torch CSR matrix (of the values promoted to fp32) for the
    library call.  Bytes: the real slots' ja and va once (4, 2 or 1 bytes
    a value), counts and rows once (and int8's row scales), the rows of
    `dense` that real slots reference once, the output once; operations:
    2 per real slot and column, on the fp32 cores."""
    import torch
    from bof_tpu_torch.sparse.spmm_cuda import promote_vals
    real = (torch.arange(ja.shape[1], device=ja.device)[None, :]
            < counts[:, None])
    width = dense.shape[1] if dense.dim() == 2 else 1
    nnz = int(real.sum())
    used = int(torch.unique(ja[real].to(torch.int64)).numel())
    nbytes = (nnz * (ja.element_size() + va.element_size())
              + ja.shape[0] * (8 if va_scale is None else 12)
              + (used + ja.shape[0]) * width * 4)
    bound, by = _bound(nbytes, 2.0 * nnz * width, FP32_FLOPS)
    rows = torch.arange(ja.shape[0], device=va.device)[:, None].expand_as(ja)
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[real], ja[real].to(torch.int64)]),
        promote_vals(va, va_scale)[real], size=(ja.shape[0], dense.shape[0]))
    return bound, by, coo.coalesce().to_sparse_csr()  # sorted, summed


def _lowp_values(va, kind):
    """An ELL block's fp32 values (NaN in padding) in a transfer mode's
    value type: (values, row scales or None, max|promoted real value|).
    bf16 keeps the NaN padding; int8 quantizes each row as
    quantize_ell_i8 does (NaN ignored by the row max, quantized 0)."""
    import numpy as np
    import torch
    from bof_tpu_torch.sparse.spmm_cuda import promote_vals
    from bof_tpu_torch.sparse.spmm_device import quantize_ell_i8
    if kind == "bf16":
        out, scale = va.to(torch.bfloat16), None
    else:
        q, sc = quantize_ell_i8(va.cpu().numpy())
        out = torch.from_numpy(q).to(va.device)
        scale = torch.from_numpy(sc).to(va.device)
    vmax = float(promote_vals(out, scale).nan_to_num(0.0).abs().max())
    return out, scale, vmax


def _in_turn(fn, bands):
    """fn over the bands in turn, one band a call."""
    import itertools
    it = itertools.cycle(bands)
    return lambda: fn(*next(it))


def ell_kernel_phase(dev) -> dict:
    """K2 and the ELL SpMV against their plain versions on the card,
    through the contract csrmm and csrgemv use (counts, a permuted rows
    into a larger sentinel-filled out, alpha); returns {name: summary}."""
    import numpy as np
    import torch
    from bof_tpu_torch.sparse.spmm_cuda import (spmm_ell, spmm_ell_ref,
                                                spmv_ell, spmv_ell_ref)
    rng = np.random.default_rng([SEED, 2])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out = {}
    worst = 0.0
    for tag, rows, rmax, k, cb, idt, alpha in (
            ("a", 512, 256, 131072, 4096, np.int32, 1.0),
            ("b", 24, 64, 65536, 999, np.uint16, 0.5),
            ("c", 8, 16384, 131072, 256, np.int32, 1.0)):
        ja, va, counts, va_max = _random_ell(rng, rows, rmax, k, idt, 0.5,
                                             dev)
        b = torch.randn((k, cb), generator=gen, device=dev)
        b_max = float(b.abs().max())
        idx, got, want, untouched = _placement(rng, rows, (cb,), dev)
        where = dict(counts=counts, rows=idx, alpha=alpha)
        before = spmm_ell.launches
        spmm_ell(b, ja, va, out=got, **where)
        torch.cuda.synchronize()
        if spmm_ell.launches != before + 1:
            raise AssertionError("the K2 count did not move")
        spmm_ell_ref(b, ja, va, out=want, **where)
        limit = _ell_tolerance(want[idx.long()], rmax, va_max, b_max, alpha)
        worst = max(worst, _check_placed(
            f"K2 ({tag}) rows {rows} rmax {rmax} k {k} cb {cb} "
            f"{np.dtype(idt).name} alpha {alpha}", got, want, untouched, idx,
            limit))
        if tag == "a":
            bound, by, csr = _ell_yardsticks(ja, va, counts, b)
            ms = _median_ms(lambda: spmm_ell(b, ja, va, out=got, **where),
                            inner=K2_INNER)
            plain_ms = _median_ms(
                lambda: spmm_ell_ref(b, ja, va, out=want, **where))
            library_ms = _median_ms(lambda: csr @ b, inner=K2_INNER)
            print(f"K2 (a): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library (torch CSR @ B) {library_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}; the kernel at "
                  f"{100 * bound / ms:.1f} % of it), median of 5 samples of "
                  f"{K2_INNER} calls back to back (the plain version: 1), "
                  "as csrmm calls it (counts, rows, out, alpha)",
                  flush=True)
            out["spmm_ell"] = {"ms": ms, "plain_ms": plain_ms,
                               "library_ms": library_ms, "bound_ms": bound,
                               "bound_by": by}
            del csr
        del got, want, b, ja, va
        torch.cuda.empty_cache()
    out["spmm_ell"]["max_abs_err"] = worst

    # K2 on the transfer modes' values as csrmm calls it: band (a) (S8's
    # int32 indices and float4 columns, timed) and band (b) (S4b's uint16
    # indices and cb 999, the scalar column path)
    for tag, rows, rmax, k, cb, idt in (
            ("a", 512, 256, 131072, 4096, np.int32),
            ("b", 24, 64, 65536, 999, np.uint16)):
        ja, va32, counts, _ = _random_ell(rng, rows, rmax, k, idt, 0.5, dev)
        b = torch.randn((k, cb), generator=gen, device=dev)
        b_max = float(b.abs().max())
        for kind in ("bf16", "s8"):
            va, scale, va_max = _lowp_values(va32, kind)
            idx, got, want, untouched = _placement(rng, rows, (cb,), dev)
            where = dict(counts=counts, rows=idx, alpha=0.5, va_scale=scale)
            before = spmm_ell.variant_launches[kind]
            spmm_ell(b, ja, va, out=got, **where)
            torch.cuda.synchronize()
            if spmm_ell.variant_launches[kind] != before + 1:
                raise AssertionError(f"the K2 {kind} count did not move")
            spmm_ell_ref(b, ja, va, out=want, **where)
            err = _check_placed(
                f"K2 {kind} ({tag}) rows {rows} rmax {rmax} k {k} cb {cb} "
                f"{np.dtype(idt).name} alpha 0.5", got, want, untouched, idx,
                _ell_tolerance(want[idx.long()], rmax, va_max, b_max, 0.5))
            entry = out.setdefault(f"spmm_ell[{kind}]", {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if tag == "a":
                bound, by, csr = _ell_yardsticks(ja, va, counts, b, scale)
                ms = _median_ms(lambda: spmm_ell(b, ja, va, out=got,
                                                 **where), inner=K2_INNER)
                plain_ms = _median_ms(lambda: spmm_ell_ref(
                    b, ja, va, out=want, **where))
                library_ms = _median_ms(lambda: csr @ b, inner=K2_INNER)
                print(f"K2 {kind} (a): kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, library (torch CSR of the "
                      f"promoted values @ B) {library_ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({by}; the kernel at "
                      f"{100 * bound / ms:.1f} % of it)", flush=True)
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound, bound_by=by)
                del csr
            del got, want, va, scale
        del b, ja, va32
        torch.cuda.empty_cache()

    rows, rmax, k = 16384, 256, 131072
    x = torch.randn((k,), generator=gen, device=dev)
    x_max = float(x.abs().max())
    bands, bounds, worst = [], [], 0.0
    for i in range(SPMV_BANDS):
        ja, va, counts, va_max = _random_ell(rng, rows, rmax, k, np.int32,
                                             0.5, dev)
        idx, got, want, untouched = _placement(rng, rows, (), dev)
        before = spmv_ell.launches
        spmv_ell(x, ja, va, counts=counts, rows=idx, out=got)
        torch.cuda.synchronize()
        if spmv_ell.launches != before + 1:
            raise AssertionError("the SpMV count did not move")
        spmv_ell_ref(x, ja, va, counts=counts, rows=idx, out=want)
        limit = _ell_tolerance(want[idx.long()], rmax, va_max, x_max)
        worst = max(worst, _check_placed(
            f"SpMV band {i} rows {rows} rmax {rmax} k {k} int32", got, want,
            untouched, idx, limit))
        bound, by, csr = _ell_yardsticks(ja, va, counts, x)
        bounds.append(bound)
        bands.append((ja, va, counts, idx, got, csr))
    ms = _median_ms(_in_turn(lambda ja, va, counts, idx, got, csr: spmv_ell(
        x, ja, va, counts=counts, rows=idx, out=got), bands),
        inner=SPMV_INNER)
    plain_ms = _median_ms(_in_turn(
        lambda ja, va, counts, idx, got, csr: spmv_ell_ref(
            x, ja, va, counts=counts, rows=idx, out=got), bands),
        inner=SPMV_INNER)
    library_ms = _median_ms(_in_turn(
        lambda ja, va, counts, idx, got, csr: csr @ x, bands),
        inner=SPMV_INNER)
    bound = statistics.mean(bounds)
    print(f"SpMV: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"(torch CSR @ x) {library_ms:.4f} ms, bound {bound:.4f} ms "
          f"({by}; the kernel at {100 * bound / ms:.1f} % of it), median of "
          f"5 samples of {SPMV_INNER} calls back to back over "
          f"{SPMV_BANDS} bands in turn, as csrgemv calls it", flush=True)
    out["spmv_ell"] = {"ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound,
                       "bound_by": by, "max_abs_err": worst}

    # the SpMV on the transfer modes' values: the same 8 bands
    for kind in ("bf16", "s8"):
        lbands, bounds, worst = [], [], 0.0
        for i, (ja, va32, counts, idx, got, _) in enumerate(bands):
            va, scale, va_max = _lowp_values(va32, kind)
            want = got.clone()
            where = dict(counts=counts, rows=idx, va_scale=scale)
            before = spmv_ell.variant_launches[kind]
            spmv_ell(x, ja, va, out=got, **where)
            torch.cuda.synchronize()
            if spmv_ell.variant_launches[kind] != before + 1:
                raise AssertionError(f"the SpMV {kind} count did not move")
            spmv_ell_ref(x, ja, va, out=want, **where)
            untouched = torch.from_numpy(np.setdiff1d(
                np.arange(got.shape[0]), idx.cpu().numpy())).to(dev)
            worst = max(worst, _check_placed(
                f"SpMV {kind} band {i}", got, want, untouched, idx,
                _ell_tolerance(want[idx.long()], rmax, va_max, x_max)))
            bound, by, csr = _ell_yardsticks(ja, va, counts, x, scale)
            bounds.append(bound)
            lbands.append((ja, va, scale, counts, idx, got, csr))
        ms = _median_ms(_in_turn(
            lambda ja, va, scale, counts, idx, got, csr: spmv_ell(
                x, ja, va, counts=counts, rows=idx, out=got, va_scale=scale),
            lbands), inner=SPMV_INNER)
        plain_ms = _median_ms(_in_turn(
            lambda ja, va, scale, counts, idx, got, csr: spmv_ell_ref(
                x, ja, va, counts=counts, rows=idx, out=got, va_scale=scale),
            lbands), inner=SPMV_INNER)
        library_ms = _median_ms(_in_turn(
            lambda ja, va, scale, counts, idx, got, csr: csr @ x, lbands),
            inner=SPMV_INNER)
        bound = statistics.mean(bounds)
        print(f"SpMV {kind}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library (torch CSR of the promoted values @ x) "
              f"{library_ms:.4f} ms, bound {bound:.4f} ms ({by}; the kernel "
              f"at {100 * bound / ms:.1f} % of it), over the same "
              f"{SPMV_BANDS} bands in turn", flush=True)
        out[f"spmv_ell[{kind}]"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by, "max_abs_err": worst}
        del lbands
    del bands
    torch.cuda.empty_cache()
    return out


def _bands(ia, entry_cap, max_nnzs) -> int:
    """The ELL bands the planners form over these offsets: count-sorted
    rows of each nnz-budgeted row block, ranged under entry_cap."""
    import numpy as np
    from bof_tpu_torch.sparse.csr import fill_row_blocks
    from bof_tpu_torch.sparse.spmm_device import ell_row_ranges
    n = 0
    for r, e in fill_row_blocks(ia, max_nnzs):
        counts = np.diff(ia[r:e + 1])
        n += len(ell_row_ranges(counts[np.argsort(counts, kind="stable")],
                                entry_cap))
    return n


def _csrmm_bands(ia, k, n) -> int:
    """K2 launches of one csrmm 'N' call at the library's defaults."""
    import importlib
    import bof_tpu_torch as bt
    from bof_tpu_torch.utils import cdiv
    cfg = bt.FlashConfig()
    cb = importlib.import_module(
        "bof_tpu_torch.sparse.csrmm")._col_block_width(n, k, cfg)
    if k * cb * 4 > cfg.hbm_budget // 3:
        raise AssertionError("this check assumes one K range")
    entry_cap = max(1 << 14, int(cfg.hbm_budget // 6 // (cb * 4)))
    return _bands(ia, entry_cap, cfg.max_nnzs) * cdiv(n, cb)


def _sparse_create(prefix, m, k, per_row, seed):
    from bof_tpu_torch.drivers import sparse_create
    from bof_tpu_torch.drivers.in_mem_sparse import load_csr
    sparse_create.main([prefix, str(m), str(k), repr(per_row),
                        "--seed", str(seed)])
    return load_csr(prefix, m, k)


def _driver_args(dev, scratch):
    return ["--o-direct", "--io-backend", "native", "--device", str(dev),
            "--scratch", scratch]


def _report_csrmm(label, wall, a_nnz, b_rows, c_rows, n, launches, stages,
                  peak, c_elem=4):
    """Print the call's throughput and stages; raise unless the writer
    took the device path's shape: no host assembly (the bands wrote their
    rows in place) and each row block and column panel downloaded once
    (c_rows * cb * npanels elements of c_elem bytes in all: 2 under the
    bf16 C download)."""
    import importlib
    import bof_tpu_torch as bt
    from bof_tpu_torch.utils import cdiv
    if "csrmm.assemble_s" in stages:
        raise AssertionError(f"[{label}] the device path assembled on the "
                             "host")
    cb = importlib.import_module("bof_tpu_torch.sparse.csrmm") \
        ._col_block_width(n, b_rows, bt.FlashConfig())
    want_d2h = c_rows * cb * cdiv(n, cb) * c_elem
    if stages.get("csrmm.d2h_bytes") != want_d2h:
        raise AssertionError(f"[{label}] downloaded "
                             f"{stages.get('csrmm.d2h_bytes')} bytes, not "
                             f"one row block a panel ({want_d2h})")
    gbytes = a_nnz * 12.0 + (b_rows + c_rows) * n * 4.0
    print(f"[{label}] wall {wall:.3f} s, {2.0 * a_nnz * n / wall / 1e9:.1f} "
          f"GFLOP/s, {gbytes / wall / 1e9:.2f} GB/s (the driver's bytes: "
          f"nnz*12 + (B + C)*4), K2 launches {launches['spmm_ell']} (= ELL "
          f"bands), peak device memory {peak / 2**30:.2f} GiB, ELL uploads "
          f"{stages.get('csrmm.h2d_bytes', 0) / 2**30:.3f} GiB", flush=True)
    _stages(label, stages, "csrmm.",
            ("disk_wait_s", "prep_s", "h2d_s", "dispatch_s", "d2h_s",
             "c_read_s", "write_wait_s"))
    print(f"[{label}] d2h {stages['csrmm.d2h_bytes'] / 2**30:.2f} GiB: "
          "each row block and panel downloaded once (in contiguous row "
          "pieces); no host assembly (csrmm.assemble_s absent)", flush=True)


def _sample_cols(c_out, cols):
    """c_out[:, cols] read in row chunks (bounded memory on a 16 GiB C)."""
    import numpy as np
    m = c_out.shape[0]
    got = np.empty((m, len(cols)))
    step = 1 << 16
    for r0 in range(0, m, step):
        got[r0:r0 + step] = c_out[r0:r0 + step][:, cols]
    return got


def csrmm_fig6_phase(dev, scratch, prefix, a_sp, modes, n=1 << 12) -> list:
    """S3 (and S8): csrmm 'N' at the paper's Fig. 6 shape, s = 1e-3, once
    for each (label, transfer_dtype, c_transfer_dtype[, sharded]) of
    `modes` on the same B, the first in fp32.  A sharded mode runs
    `drivers.csrmm --sharded` (csrmm_sharded on a 1 x 1 NCCL mesh: whole
    row blocks, count-sorted bands, K2 a band into the block's rows) under
    the same gate and band count.  Returns each run's launches."""
    import numpy as np
    from bof_tpu_torch.drivers import csrmm as csrmm_driver
    m, k = a_sp.shape
    shape = f"csrmm N {m}x{k}x{n} nnz={a_sp.nnz}"
    rng = np.random.default_rng([SEED, 3])
    b_path = os.path.join(scratch, "B_fig6.bin")
    c_path = os.path.join(scratch, "C_fig6.bin")
    t0 = time.perf_counter()
    b_max, = _write_operands(dev, scratch, [(b_path, (k, n), "R")], rng)
    print(f"[S3 {shape}] B written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    want_bands = _csrmm_bands(a_sp.indptr, k, n)
    print(f"[S3 {shape}] planner forms {want_bands} ELL bands (recomputed "
          f"in {time.perf_counter() - t0:.1f} s)", flush=True)
    rows = np.sort(rng.choice(m, N_SAMPLES, replace=False))
    cols = np.sort(rng.choice(n, N_SAMPLES, replace=False))
    row_max = int(np.diff(a_sp.indptr).max())
    atol = ATOL_SCALE * row_max ** 0.5 * float(np.abs(a_sp.data).max()) \
        * b_max
    runs, want, base_h2d = [], None, None
    for tag, xfer, c_xfer, *sharded in modes:
        sharded = bool(sharded and sharded[0])
        label = (f"{tag} {shape} transfer={xfer} c_transfer={c_xfer}"
                 + (" sharded (1x1 NCCL mesh)" if sharded else ""))
        argv = [prefix, str(m), str(k), b_path, str(n), c_path,
                "--create-c", *_driver_args(dev, scratch)] + (
                    ["--sharded"] if sharded else [])
        with _configured(csrmm_driver, transfer_dtype=xfer,
                         c_transfer_dtype=c_xfer):
            wall, launches, stages, peak = _drive(
                dev, csrmm_driver.main, argv,
                profile=(bool(os.environ.get("BOF_SMOKE_PROFILE"))
                         and base_h2d is None))
        vkind = ELL_OF[xfer]
        _check_launches(label, launches, {"spmm_ell": want_bands,
                                          f"spmm_ell[{vkind}]": want_bands})
        if sharded:  # no collective on one rank: the rows are its own
            print(f"[{label}] wall {wall:.3f} s, "
                  f"{2.0 * a_sp.nnz * n / wall / 1e9:.1f} GFLOP/s, K2 "
                  f"launches {launches['spmm_ell']} (= ELL bands), peak "
                  f"device memory {peak / 2**30:.2f} GiB", flush=True)
        else:
            _report_csrmm(label, wall, a_sp.nnz, k, m, n, launches, stages,
                          peak, c_elem=2 if c_xfer == "bfloat16" else 4)
        h2d = stages.get("csrmm.h2d_bytes")
        if sharded:  # (ELL upload bytes: the one-card pipeline's metric)
            pass
        elif base_h2d is None:
            base_h2d = h2d
        elif not h2d < base_h2d:
            raise AssertionError(f"[{label}] ELL uploads {h2d} bytes, not "
                                 f"fewer than the fp32 run's {base_h2d}")
        else:
            print(f"[{label}] ELL uploads {h2d / base_h2d:.3f} of the fp32 "
                  "run's bytes", flush=True)

        if want is None:
            t0 = time.perf_counter()
            b = _logical(b_path, (k, n), "R")
            sub_a = a_sp[rows]
            used = np.unique(sub_a.indices)
            want = (sub_a[:, used].astype(np.float64)
                    @ np.asarray(b[used], np.float64),
                    a_sp.astype(np.float64) @ np.asarray(b[:, cols],
                                                         np.float64))
            del b
            print(f"[{label}] reference computed in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        c_out = _logical(c_path, (m, n), "R")
        pairs = [(np.asarray(c_out[rows], np.float64), want[0]),
                 (_sample_cols(c_out, cols), want[1])]
        del c_out
        if xfer == c_xfer == "float32":
            _verify(label, pairs, atol,
                    "1e-5*sqrt(max nnz/row)*max|A|*max|B|")
        else:
            _verify_band(label, pairs, BANDS[(xfer, c_xfer)])
        runs.append(launches)
    for p in (b_path, c_path):
        _retire(p)
    return runs


def csrmm_trans_phase(dev, scratch, modes, m=65536, k=262144, n=999,
                      per_row=64.0) -> list:
    """S4 (and S4b): csrmm 'T' through csrcsc scratch and the 'N' recursion
    (uint16 indices, cb 999), alpha 0.5, beta 2 on a seeded column-major
    C, once for each (label, transfer_dtype, c_transfer_dtype) of `modes`
    on the same files, each from the same starting C, the first in fp32.
    Returns each run's launches."""
    import numpy as np
    from bof_tpu_torch.drivers import csrmm as csrmm_driver
    alpha, beta = 0.5, 2.0
    prefix = os.path.join(scratch, "A2")
    t0 = time.perf_counter()
    a_sp = _sparse_create(prefix, m, k, per_row, SEED + 4)
    shape = f"csrmm T {m}x{k}x{n} nnz={a_sp.nnz} order C"
    rng = np.random.default_rng([SEED, 4])
    b_path = os.path.join(scratch, "B2.bin")
    c_path = os.path.join(scratch, "C2.bin")
    c0_path = c_path + ".0"
    b_max, _ = _write_operands(dev, scratch, [(b_path, (m, n), "C"),
                                              (c_path, (k, n), "C")], rng)
    shutil.copyfile(c_path, c0_path)
    at = a_sp.T.tocsr()
    want_bands = _csrmm_bands(at.indptr.astype(np.int64), m, n)
    rows = np.sort(rng.choice(k, N_SAMPLES, replace=False))
    cols = np.sort(rng.choice(n, N_SAMPLES, replace=False))
    c0 = _logical(c_path, (k, n), "C")
    c0_rows = np.asarray(c0[rows], np.float64)
    c0_cols = np.asarray(c0[:, cols], np.float64)
    del c0
    print(f"[S4 {shape}] operands written in {time.perf_counter() - t0:.1f} "
          f"s; planner forms {want_bands} ELL bands", flush=True)
    b64 = np.asarray(_logical(b_path, (m, n), "C"), np.float64)
    want = (alpha * (at[rows] @ b64) + beta * c0_rows,
            alpha * (at.astype(np.float64) @ b64[:, cols]) + beta * c0_cols)
    del b64
    row_max = int(np.diff(at.indptr).max())
    atol = ATOL_SCALE * row_max ** 0.5 * float(np.abs(a_sp.data).max()) \
        * b_max * abs(alpha)
    runs = []
    for i, (tag, xfer, c_xfer) in enumerate(modes):
        label = f"{tag} {shape} transfer={xfer} c_transfer={c_xfer}"
        if i:
            shutil.copyfile(c0_path, c_path)
        argv = [prefix, str(m), str(k), b_path, str(n), c_path, "--ta", "T",
                "--order-b", "C", "--alpha", repr(alpha), "--beta",
                repr(beta), *_driver_args(dev, scratch)]
        with _configured(csrmm_driver, transfer_dtype=xfer,
                         c_transfer_dtype=c_xfer):
            wall, launches, stages, peak = _drive(dev, csrmm_driver.main,
                                                  argv)
        vkind = ELL_OF[xfer]
        _check_launches(label, launches, {"spmm_ell": want_bands,
                                          f"spmm_ell[{vkind}]": want_bands})
        _report_csrmm(label, wall, a_sp.nnz, m, k, n, launches, stages, peak,
                      c_elem=2 if c_xfer == "bfloat16" else 4)
        c_out = _logical(c_path, (k, n), "C")
        pairs = [(np.asarray(c_out[rows], np.float64), want[0]),
                 (np.asarray(c_out[:, cols], np.float64), want[1])]
        del c_out
        if xfer == c_xfer == "float32":
            _verify(label, pairs, atol,
                    "1e-5*sqrt(max nnz/row of A^T)*max|A|*max|B|*|alpha|")
        else:
            _verify_band(label, pairs, BANDS[(xfer, c_xfer)])
        runs.append(launches)
    for p in (b_path, c_path, c0_path) + tuple(
            prefix + x for x in (".off", ".col", ".csr")):
        os.unlink(p)
    return runs


def csrgemv_phase(dev, scratch, prefix, a_sp, trans, tag="S5",
                  xfer="float32") -> dict:
    """S5 (and S9): csrgemv on S3's A, its values crossing the link as
    `xfer` says; the whole y against float64 scipy."""
    import numpy as np
    from bof_tpu_torch.drivers import csrgemv as csrgemv_driver
    m, k = a_sp.shape
    label = f"{tag} csrgemv {trans} {m}x{k} nnz={a_sp.nnz} transfer={xfer}"
    rng = np.random.default_rng([SEED, 5, trans == "T"])
    x = rng.standard_normal(m if trans == "T" else k, dtype=np.float32)
    x_path = os.path.join(scratch, "x.bin")
    y_path = os.path.join(scratch, "y.bin")
    x.tofile(x_path)
    want_bands = 0
    if trans == "N":
        import bof_tpu_torch as bt
        want_bands = _bands(a_sp.indptr, 1 << 22, bt.FlashConfig().max_nnzs)
    argv = [prefix, str(m), str(k), x_path, y_path, "--trans", trans,
            *_driver_args(dev, scratch)]
    with _configured(csrgemv_driver, transfer_dtype=xfer,
                     c_transfer_dtype="float32"):
        wall, launches, stages, peak = _drive(dev, csrgemv_driver.main,
                                              argv)
    if trans == "N":
        _check_launches(label, launches, {
            "spmv_ell": want_bands, f"spmv_ell[{ELL_OF[xfer]}]": want_bands})
    elif any(launches.values()):
        raise AssertionError(f"[{label}] 'T' runs on the host, but "
                             f"launched {launches}")
    print(f"[{label}] wall {wall:.3f} s, {2.0 * a_sp.nnz / wall / 1e9:.2f} "
          f"GFLOP/s, {a_sp.nnz * 12.0 / wall / 1e9:.2f} GB/s (the driver's "
          f"bytes: nnz*12), SpMV launches {launches['spmv_ell']}, peak "
          f"device memory {peak / 2**30:.2f} GiB, ELL uploads "
          f"{stages.get('csrgemv.h2d_bytes', 0) / 2**30:.3f} GiB",
          flush=True)
    _stages(label, stages, "csrgemv.", ("disk_wait_s", "prep_s", "h2d_s",
                                        "dispatch_s", "d2h_s", "compute_s"))
    y = np.fromfile(y_path, np.float32).astype(np.float64)
    op = a_sp.T if trans == "T" else a_sp
    want = op.astype(np.float64) @ x.astype(np.float64)
    inner = int(np.diff(op.tocsr().indptr).max())
    atol = ATOL_SCALE * inner ** 0.5 * float(np.abs(a_sp.data).max()) \
        * float(np.abs(x).max())
    if xfer == "float32":
        _verify(label, [(y, want)], atol,
                "1e-5*sqrt(max nnz/row of op(A))*max|A|*max|x|")
    else:
        _verify_band(label, [(y, want)], BANDS[(xfer, "float32")])
    for p in (x_path, y_path):
        os.unlink(p)
    return launches


# --------------------------------------------------------- the applications

TOPK_INNER = 20       # B8 calls a timing sample (microseconds each)


def topk_kernel_phase(dev) -> dict:
    """B8 (`row_topk`) against its plain version on the card, values and
    columns bit for bit (the order is a total one): the fused XML step's
    band (rows 512, lb_max 1024, k 5) and X1's (rows 2048), k 1, k =
    lb_max, all-equal rows, a -inf tail wider than the real labels (all
    on the register body), lb_max 4096 (the 'smem' body) and lb_max 8192
    (the 'l2' body).  The band is timed beside the plain version,
    torch.topk on the masked scores (the library yardstick, never called
    by the port) and the bound: the scores and mask read once and k
    (value, index) pairs a row written, over 3.35 TB/s; X1's band on the
    card alone too."""
    import torch
    from bof_tpu_torch.ops.topk_cuda import (row_topk, row_topk_ref,
                                             topk_variant)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    out = x1 = None
    for tag, rows, lb_max, lb, k, fill in (
            ("band", 512, 1024, 1024, 5, "normal"),
            ("k=1", 512, 1024, 1024, 1, "normal"),
            ("k=lb", 512, 1024, 1024, 1024, "normal"),
            ("ties", 512, 1024, 1024, 16, "equal"),
            ("-inf tail", 512, 1024, 40, 64, "normal"),
            ("X1 band", 2048, 1024, 1000, 5, "normal"),
            ("lb 4096", 256, 4096, 4096, 5, "normal"),
            ("lb 8192", 256, 8192, 8192, 5, "normal")):
        s = torch.randn((rows, lb_max), generator=gen, device=dev)
        if fill == "equal":
            s.fill_(0.25)
        mask = torch.zeros(lb_max, device=dev)
        mask[lb:] = float("-inf")
        variant = topk_variant(lb_max)
        before = row_topk.variant_launches[variant]
        got_v, got_i = row_topk(s, mask, k)
        torch.cuda.synchronize()
        if row_topk.variant_launches[variant] != before + 1:
            raise AssertionError(f"B8 ({tag}): the '{variant}' count did "
                                 "not move")
        want_v, want_i = row_topk_ref(s, mask, k)
        same = (torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
                and torch.equal(got_i, want_i))
        print(f"B8 ({tag}) rows {rows} lb_max {lb_max} real labels {lb} k "
              f"{k} ({variant}): values and columns bit-identical to the "
              f"plain version: {same}", flush=True)
        if not same:
            raise AssertionError(f"B8 ({tag}) disagrees with its plain "
                                 "version")
        if tag == "band":
            x = s + mask
            nbytes = (rows * lb_max + lb_max) * 4 + rows * k * 8
            bound, by = _bound(nbytes, 0.0, FP32_FLOPS)
            ms = _median_ms(lambda: row_topk(s, mask, k), inner=TOPK_INNER)
            plain_ms = _median_ms(lambda: row_topk_ref(s, mask, k))
            library_ms = _median_ms(lambda: torch.topk(x, k, dim=1),
                                    inner=TOPK_INNER)
            # the same calls on the card alone (behind a sleep kernel):
            # a few microseconds of kernel under the host's launch cost
            ms_q = _median_ms(lambda: row_topk(s, mask, k),
                              inner=TOPK_INNER, queued=True)
            library_q = _median_ms(lambda: torch.topk(x, k, dim=1),
                                   inner=TOPK_INNER, queued=True)
            print(f"B8 (band): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library (torch.topk of the masked scores) "
                  f"{library_ms:.4f} ms, bound {bound:.4f} ms ({by}; the "
                  f"kernel at {100 * bound / ms:.1f} % of it), median of 5 "
                  f"samples of {TOPK_INNER} calls back to back (the plain "
                  f"version: 1); on the card alone: kernel {ms_q:.4f} ms "
                  f"({100 * bound / ms_q:.1f} % of the bound), torch.topk "
                  f"{library_q:.4f} ms", flush=True)
            out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
                   "ms_queued": ms_q, "library_ms_queued": library_q}
        if tag == "X1 band":
            x = s + mask
            nbytes = (rows * lb_max + lb_max) * 4 + rows * k * 8
            bound_x1, _ = _bound(nbytes, 0.0, FP32_FLOPS)
            x1_q = _median_ms(lambda: row_topk(s, mask, k), inner=TOPK_INNER,
                              queued=True)
            x1_lib = _median_ms(lambda: torch.topk(x, k, dim=1),
                                inner=TOPK_INNER, queued=True)
            print(f"B8 (X1 band, 2048 x 1024, k 5) on the card alone: kernel "
                  f"{x1_q:.4f} ms ({100 * bound_x1 / x1_q:.1f} % of the "
                  f"{bound_x1:.4f} ms bound), torch.topk {x1_lib:.4f} ms",
                  flush=True)
            x1 = {"x1_band_ms_queued": x1_q,
                  "x1_band_library_ms_queued": x1_lib,
                  "x1_band_bound_ms": bound_x1}
        del s, mask, got_v, got_i, want_v, want_i
    return {"row_topk": {**out, **x1}}


B10_SPECIALS = {  # +-0, +-inf, NaNs of both signs with payloads
    4: [-0x80000000, 0, 0x7F800000, -0x00800000, 0x7FC00000, -0x00400000,
        0x7FC00123, -0x007FFFFF, 0x7F800777],
    2: [-0x8000, 0, 0x7C00, -0x0400, 0x7E00, -0x0200, 0x7E12, -0x03FF,
        0x7C07]}


def _b10_bits(gen, dev, n, dtype):
    """n seeded elements of numpy dtype `dtype` as a tensor of their bits
    (int32, int16 or uint8), made on the card: floats N(0, 1) with a
    quarter rounded to 0.01 (duplicates) and one in each 64 set to +-0,
    +-inf or a NaN of either sign with a payload; integers uniform over their
    range with a quarter drawn from 64 values; bool 0/1."""
    import numpy as np
    import torch
    dt = np.dtype(dtype)
    if dt.kind == "f":
        tdt = torch.float32 if dt.itemsize == 4 else torch.float16
        x = torch.randn(n, generator=gen, device=dev).to(tdt)
        q = n // 4
        x[:q] = torch.round(x[:q] * 100) / 100
        bits = x.view(torch.int32 if dt.itemsize == 4 else torch.int16)
        sp = torch.tensor(B10_SPECIALS[dt.itemsize], dtype=bits.dtype,
                          device=dev)
        m = n // 64  # one a 64-element stretch: distinct places, so the
        #   assignment is deterministic
        at = torch.arange(m, device=dev) * 64 + torch.randint(
            0, 64, (m,), generator=gen, device=dev)
        bits[at] = sp[torch.randint(0, len(sp), (m,), generator=gen,
                                    device=dev)]
        return bits
    if dt == np.bool_:
        return torch.randint(0, 2, (n,), generator=gen, device=dev,
                             dtype=torch.uint8)
    tdt = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[dt.itemsize]
    wide = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen,
                         device=dev)
    bits = (wide & ((1 << (8 * dt.itemsize)) - 1)).to(tdt)
    q = n // 4
    bits[:q] = bits[q:q + 64][torch.randint(0, 64, (q,), generator=gen,
                                            device=dev)]
    return bits


B10_SKEWED = ("all_equal", "zeros_alternating", "sorted", "reverse",
              "two_alternating", "all_nans")


def _b10_skewed(gen, dev, n, dtype, case):
    """n elements of float32 or uint8 (as int32 or uint8 bits, made on the
    card) in one of B10's skewed or ordered cases: all equal, +-0.0
    alternating, already sorted and reverse sorted (`_b10_bits` in B10's
    order), two values alternating, all NaNs of both signs with payloads
    (the last two float cases float32 only)."""
    import numpy as np
    import torch
    from bof_tpu_torch.ops.sort_cuda import sort_block_ref
    f32 = np.dtype(dtype) == np.float32
    tdt = torch.int32 if f32 else torch.uint8
    if case == "all_equal":
        return torch.full((n,), 0x3FC00000 if f32 else 200, dtype=tdt,
                          device=dev)  # 1.5
    if case == "zeros_alternating":
        bits = torch.zeros(n, dtype=tdt, device=dev)
        bits[::2] = -0x80000000
        return bits
    if case == "two_alternating":
        bits = torch.full((n,), 0x40200000 if f32 else 250, dtype=tdt,
                          device=dev)  # 2.5
        bits[1::2] = -0x40800000 if f32 else 5  # -1.0
        return bits
    if case == "all_nans":
        bits = torch.randint(1, 0x800000, (n,), generator=gen, device=dev,
                             dtype=tdt) | 0x7F800000
        neg = torch.rand(n, generator=gen, device=dev) < 0.5
        return torch.where(neg, bits | -0x80000000, bits)
    bits = sort_block_ref(_b10_bits(gen, dev, n, dtype), dtype)
    return bits if case == "sorted" else bits.flip(0)


def sort_kernel_phase(dev) -> dict:
    """B10 (`sort_block`) against its plain version on the card for every
    element type it takes, at 2^24 elements and at a ragged 1,000,003
    (`_b10_bits`: floats with +-0, +-inf, signed NaNs with payloads and
    duplicates), and at 2^24 float32 and uint8 on the skewed and ordered
    inputs of `_b10_skewed`: bit for bit, two launches bit-identical, the
    input not written.  At 2^24 float32 the kernel (a lone call and on
    the card alone, behind a sleep kernel; on the random and the all-equal
    input), its kernels' device times, the plain version, the library
    yardstick torch.sort(stable=True) (never called by the port; CUB's
    radix sort, which puts -0.0 before +0.0), the bound (the block read
    once and written once over 3.35 TB/s) and the one-sweep design's
    floors (a pass reads and writes the block once; the histogram reads it
    once more); the kernel's time at 2^24 for every other element type
    too."""
    import numpy as np
    import torch
    from bof_tpu_torch.ops.sort_cuda import (SORT_KINDS, sort_block,
                                             sort_block_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)

    def check(label, bits, dt):
        keep = bits.clone()
        before = sort_block.launches
        got = sort_block(bits, dt)
        again = sort_block(bits, dt)
        want = sort_block_ref(bits, dt)
        torch.cuda.synchronize()
        same = (torch.equal(got, want) and torch.equal(again, want)
                and torch.equal(bits, keep)
                and sort_block.launches == before + 2)
        print(f"B10 {label}: bit-identical to the plain version, twice, "
              f"input unchanged: {same}", flush=True)
        if not same:
            raise AssertionError(f"B10 ({label}) disagrees with its plain "
                                 "version")

    out = None
    n = 1 << 24
    for dt in SORT_KINDS:
        for m in (n, 1_000_003):
            bits = _b10_bits(gen, dev, m, dt)
            check(f"{dt.name} n {m}", bits, dt)
            if m == n:
                ms = _median_ms(lambda: sort_block(bits, dt), reps=3)
                print(f"B10 {dt.name} n {m}: kernel {ms:.4f} ms", flush=True)
            if dt == np.float32 and m == n:
                x = bits.view(torch.float32)
                bound, by = _bound(2 * n * 4, 0.0, FP32_FLOPS)
                pass_floor = 2 * n * 4 / HBM_BPS * 1e3
                design_floor = (2 * 4 + 1) * n * 4 / HBM_BPS * 1e3
                ms = _median_ms(lambda: sort_block(bits, dt))
                ms_queued = _median_ms(lambda: sort_block(bits, dt),
                                       inner=10, queued=True)
                by_kernel = _device_ms_by_kernel(
                    lambda: sort_block(bits, dt), SORT_KERNELS)
                plain_ms = _median_ms(lambda: sort_block_ref(bits, dt))
                library_ms = _median_ms(lambda: torch.sort(x, stable=True))
                library_queued = _median_ms(
                    lambda: torch.sort(x, stable=True), inner=10,
                    queued=True)
                print(f"B10 (float32, 2^24): kernel {ms:.4f} ms a lone call, "
                      f"{ms_queued:.4f} ms on the card alone (hist "
                      f"{by_kernel['sort_hist_kernel']:.4f} ms + 4 passes "
                      f"{by_kernel['sort_onesweep_kernel']:.4f} ms, "
                      f"torch.profiler); plain {plain_ms:.4f} ms, library "
                      f"(torch.sort, stable) {library_ms:.4f} ms, alone "
                      f"{library_queued:.4f} ms; bound {bound:.4f} ms "
                      f"({by}; the kernel at {100 * bound / ms_queued:.1f} "
                      f"% of it alone), this design's floor {pass_floor:.4f}"
                      f" ms a pass, {design_floor:.4f} ms in all (9 reads "
                      "or writes of the block); medians of 5 samples",
                      flush=True)
                out = {"ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound,
                       "bound_by": by, "max_abs_err": 0.0,
                       "ms_queued": ms_queued,
                       "library_ms_queued": library_queued,
                       "pass_floor_ms": pass_floor,
                       "design_floor_ms": design_floor,
                       "hist_ms": by_kernel["sort_hist_kernel"],
                       "onesweep_ms": by_kernel["sort_onesweep_kernel"]}
            del bits
    for dt in (np.float32, np.uint8):
        for case in B10_SKEWED:
            if dt != np.float32 and case in ("zeros_alternating",
                                             "all_nans"):
                continue
            bits = _b10_skewed(gen, dev, n, dt, case)
            check(f"{np.dtype(dt).name} n {n} {case}", bits, dt)
            if case == "all_equal":
                ms = _median_ms(lambda: sort_block(bits, dt))
                ms_queued = _median_ms(lambda: sort_block(bits, dt),
                                       inner=10, queued=True)
                print(f"B10 {np.dtype(dt).name} n {n} all equal: kernel "
                      f"{ms:.4f} ms a lone call, {ms_queued:.4f} ms on the "
                      "card alone", flush=True)
                if dt == np.float32:
                    out["ms_all_equal"] = ms
                    out["ms_all_equal_queued"] = ms_queued
                    print(f"B10 (float32, 2^24) alone: random "
                          f"{out['ms_queued']:.4f} ms, all equal "
                          f"{ms_queued:.4f} ms", flush=True)
            del bits
    torch.cuda.empty_cache()
    return {"sort_block": out}


def _app_report(label, wall, flops, launches, stages, peak, prefix, keys):
    print(f"[{label}] wall {wall:.3f} s, {flops / wall / 1e9:.1f} GFLOP/s "
          f"(the driver's formula), launches K2 {launches['spmm_ell']}, B8 "
          f"{launches['row_topk']}, B7 {launches['lloyd_assign']} + "
          f"{launches['lloyd_accumulate']}, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    _stages(label, stages, prefix, keys)


def _eig_bands(a_sp, b) -> tuple:
    """(forward, transposed) ELL bands the one-pass operator forms in one
    application to a V of b columns at the library's defaults: count-sorted
    rows of each nnz-budgeted row block ranged under its entry cap, and for
    each such band, the count-sorted words its rows touch ranged the same
    way (a word no row of the band holds is never planned)."""
    import numpy as np
    import bof_tpu_torch as bt
    from bof_tpu_torch.apps.eigensolver import _gram_entry_cap
    from bof_tpu_torch.sparse.csr import fill_row_blocks
    from bof_tpu_torch.sparse.spmm_device import ell_row_ranges
    cfg = bt.FlashConfig()
    entry_cap = _gram_entry_cap(cfg.hbm_budget, a_sp.shape[1], b)
    fwd = trans = 0
    for r, e in fill_row_blocks(a_sp.indptr, cfg.max_nnzs):
        blk = a_sp[r:e]
        counts = np.diff(blk.indptr)
        order = np.argsort(counts, kind="stable")
        for s0, s1 in ell_row_ranges(counts[order], entry_cap):
            fwd += 1
            ccounts = np.bincount(blk[order[s0:s1]].indices,
                                  minlength=a_sp.shape[1])
            ccounts = ccounts[ccounts > 0]
            if len(ccounts):
                trans += len(ell_row_ranges(np.sort(ccounts), entry_cap))
    return fwd, trans


def eigensolver_phase(dev, scratch, prefix, a_sp, restarts=1) -> dict:
    """E1: drivers.eigensolver on S3's A, block Lanczos, 64 values,
    `restarts` restarts, one pass over A an operator application,
    sparse_compute 'auto' (the card).  Fails unless K2 launched (forward +
    transposed bands) x applications times, one application to 8 columns
    of the returned V is within rtol 1e-4 (atol 1e-5 max|U|) of float64
    scipy, sigma_i^2 is within rtol 1e-4 of |A v_i|^2 (float64) for the top
    8, and V is orthonormal to 1e-5."""
    import importlib
    import numpy as np
    import bof_tpu_torch as bt
    from bof_tpu_torch.drivers import eigensolver as eig_driver
    m, k = a_sp.shape
    n_vals = 64
    label = (f"E1 eigensolver lanczos {m}x{k} nnz={a_sp.nnz} "
             f"n_vals={n_vals} restarts={restarts}")
    t0 = time.perf_counter()
    fwd, trans = _eig_bands(a_sp, n_vals)
    print(f"[{label}] the operator forms {fwd} forward + {trans} transposed "
          f"bands an application (recomputed in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    res = {}

    def run(argv):
        t = time.perf_counter()
        res["out"] = eig_driver.main(argv)
        return time.perf_counter() - t
    argv = [prefix, str(m), str(k), str(n_vals), "--iters", str(restarts),
            "--solver", "lanczos", *_driver_args(dev, scratch)]
    wall, launches, stages, peak = _drive(
        dev, run, argv, profile=bool(os.environ.get("BOF_SMOKE_PROFILE")))
    applies = int(stages["eig.op_applies"])
    want = (fwd + trans) * applies
    _check_launches(label, launches, {"spmm_ell": want,
                                      "spmm_ell[f32]": want})
    _app_report(label, wall, 4.0 * a_sp.nnz * n_vals * restarts, launches,
                stages, peak, "eig.",
                ("disk_wait_s", "prep_s", "transpose_s", "h2d_s",
                 "dispatch_s", "fold_s", "d2h_s"))
    print(f"[{label}] {applies} operator applications, K2 launches "
          f"{launches['spmm_ell']} = ({fwd} + {trans}) x {applies}; link "
          f"up {stages.get('eig.h2d_bytes', 0) / 2**30:.3f} GiB, down "
          f"{stages.get('eig.d2h_bytes', 0) / 2**30:.3f} GiB", flush=True)
    sigma, v = res["out"]
    t0 = time.perf_counter()
    gram = v.T.astype(np.float64) @ v.astype(np.float64)
    orth = float(np.abs(gram - np.eye(n_vals)).max())
    v8 = v[:, :8]
    eig = importlib.import_module("bof_tpu_torch.apps.eigensolver")
    ctx = _new_ctx(dev, scratch)
    try:
        A = bt.CsrFlashMatrix.map_files(prefix, (m, k), ctx=ctx)
        u = eig._apply_ata_one_pass(A, v8, ctx)
    finally:
        ctx.destroy()
    a64 = a_sp.astype(np.float64)
    w64 = a64 @ v8.astype(np.float64)
    u64 = a64.T @ w64
    del a64
    atol = 1e-5 * float(np.abs(u64).max())
    u_err = float((np.abs(u - u64) / (1e-4 * np.abs(u64) + atol)).max())
    av2 = (w64 * w64).sum(0)
    s_err = float((np.abs(sigma[:8] ** 2 - av2) / (1e-4 * av2)).max())
    ok = u_err <= 1.0 and s_err <= 1.0 and orth <= 1e-5
    print(f"[{label}] sigma[:4] {sigma[:4].tolist()}; U = A^T A V on 8 "
          f"columns of V: worst err/(1e-4*|U64| + 1e-5*max|U64|) "
          f"{u_err:.4f}; sigma^2 against |A v|^2 (float64), top 8: worst "
          f"err/(1e-4*|A v|^2) {s_err:.4f}; max|V^T V - I| {orth:.3g} "
          f"(limit 1e-5); checked in {time.perf_counter() - t0:.1f} s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{label}] disagrees with float64")
    return launches


def xml_phase(dev, scratch, prefix, a_sp, n_labels=4096, k=5,
              sharded=False) -> dict:
    """X1: drivers.xml_rank on S3's A as docs x vocab against W of
    n_labels x 2^17 seeded N(0, 1) fp32 labels (written over a spare's
    blocks), k 5, fused.  Fails unless, for 64 seeded documents, the scores
    and labels meet tests/test_apps.py's _check_topk criteria (rtol 2e-4,
    atol 1e-5 sqrt(max nnz/row) max|A| max|W|) against float64 dense
    scores, K2 and B8 launched once a band a label block, and only
    rows * k * 8 bytes a label block came down.  `sharded`: S14's run with
    --sharded (xml_rank(mesh=) on a 1 x 1 NCCL mesh: K2 and B8 on the
    rank's run of each band, two all-gathers of rows x k a band), the
    same gate."""
    import numpy as np
    import torch
    import bof_tpu_torch as bt
    from bof_tpu_torch.drivers import xml_rank as xml_driver
    docs, vocab = a_sp.shape
    label = (f"{'S14 ' if sharded else ''}X1 xml_rank {docs}x{vocab} "
             f"nnz={a_sp.nnz} labels={n_labels} k={k} fused"
             + (" sharded (1x1 NCCL mesh)" if sharded else ""))
    w_path = os.path.join(scratch, "W_xml.bin")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    t0 = time.perf_counter()
    w_max = float(_write_normals(w_path, (n_labels, vocab), gen, dev,
                                 np.float32).max())
    print(f"[{label}] W written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = bt.FlashConfig()
    lb_max = max(k, min(n_labels, cfg.program_budget // 16 // (vocab * 4),
                        4096))
    blocks = -(-n_labels // lb_max)
    bands = _bands(a_sp.indptr, max(1 << 14, cfg.hbm_budget // 6
                                    // (lb_max * 4)), cfg.max_nnzs)
    res = {}

    def run(argv):
        t = time.perf_counter()
        res["out"] = xml_driver.main(argv)
        return time.perf_counter() - t
    argv = [prefix, str(docs), str(vocab), w_path, str(n_labels), str(k),
            "--fused", "on", *_driver_args(dev, scratch)] + (
                ["--sharded"] if sharded else [])
    wall, launches, stages, peak = _drive(
        dev, run, argv,
        profile=bool(os.environ.get("BOF_SMOKE_PROFILE")) and not sharded)
    want = bands * blocks
    _check_launches(label, launches, {
        "spmm_ell": want, "spmm_ell[f32]": want, "row_topk": want,
        "row_topk[reg]": want})
    if sharded:
        _check_collectives(label, stages, {"all_gather": 2 * want})
    _app_report(label, wall, 2.0 * a_sp.nnz * n_labels, launches, stages,
                peak, "xml_rank.", ("w_wait_s", "w_h2d_s", "disk_wait_s",
                                    "prep_s", "h2d_s", "dispatch_s", "d2h_s",
                                    "merge_s"))
    d2h = stages.get("xml_rank.d2h_bytes")
    print(f"[{label}] {blocks} label blocks of {lb_max} x {bands} bands; "
          f"K2 and B8 {want} launches each; d2h {d2h} bytes (expected "
          f"{docs * k * 8 * blocks}: rows*k*8 a band); ELL and W uploads "
          f"{stages.get('xml_rank.h2d_bytes', 0) / 2**30:.3f} GiB",
          flush=True)
    if d2h != docs * k * 8 * blocks:
        raise AssertionError(f"[{label}] more than the top-k came down")
    scores, labels = res["out"]
    t0 = time.perf_counter()
    rng = np.random.default_rng([SEED, 13])
    rows = np.sort(rng.choice(docs, 64, replace=False))
    a_rows = a_sp[rows].astype(np.float64)
    w = np.memmap(w_path, np.float32, "r", shape=(n_labels, vocab))
    s64 = np.empty((64, n_labels))
    for l0 in range(0, n_labels, 512):
        s64[:, l0:l0 + 512] = a_rows @ np.asarray(w[l0:l0 + 512],
                                                  np.float64).T
    del w
    got_s, got_l = scores[rows].astype(np.float64), labels[rows]
    if got_l.min() < 0 or got_l.max() >= n_labels:
        raise AssertionError(f"[{label}] a label outside [0, {n_labels})")
    row_max = int(np.diff(a_sp.indptr).max())
    atol = ATOL_SCALE * row_max ** 0.5 * float(np.abs(a_sp.data).max()) \
        * w_max
    want_sorted = -np.sort(-s64, axis=1)[:, :k]
    true_s = s64[np.arange(64)[:, None], got_l]
    err = max(float((np.abs(got_s - want_sorted)
                     / (2e-4 * np.abs(want_sorted) + atol)).max()),
              float((np.abs(got_s - true_s)
                     / (2e-4 * np.abs(true_s) + atol)).max()))
    print(f"[{label}] 64 seeded documents against float64 dense scores: "
          f"worst err/(2e-4*|s| + atol) {err:.4f} over the sorted top-{k} "
          f"and the reported labels' true scores (atol {atol:.3g} = "
          f"1e-5*sqrt(max nnz/row)*max|A|*max|W|); checked in "
          f"{time.perf_counter() - t0:.1f} s {'ok' if err <= 1 else 'FAIL'}",
          flush=True)
    if err > 1.0:
        raise AssertionError(f"[{label}] disagrees with float64")
    _retire(w_path)
    return launches


def topic_phase(dev, scratch, prefix, a_sp, n_topics=1000, proj_dim=64,
                iters=4, sample_rate=0.1) -> dict:
    """T1: drivers.topic_model on S3's A, 1000 topics, proj_dim 64, the
    ISLE sample rate 0.1, `iters` Lloyd iterations.  Fails unless 16 seeded
    rows of the projection P = A R (read as the run wrote it) are within
    the csrmm gate of float64; the full assignment's labels of those rows
    and of ASSIGN_ROWS seeded consecutive rows (P read back as that pass
    reads it) equal the plain version's (`lloyd_assign_ref` against the
    centers the pass was given) but at float64 near-ties; every label is
    in [0, n_topics); the unnormalized lift is float64 one_hot(labels)^T A
    within rtol 1e-4, atol 1e-6; the topic-word matrix is that lift over
    its float32 row sums within one rounding (2^-24 relative), zero on
    the rows whose float32 sum is <= 0; K2 launched once a projection band
    and B7 launched."""
    import importlib
    import numpy as np
    import torch
    from bof_tpu_torch.drivers import topic_model as tm_driver
    from bof_tpu_torch.ops import kmeans as km
    docs, vocab = a_sp.shape
    label = (f"T1 topic_model {docs}x{vocab} nnz={a_sp.nnz} "
             f"topics={n_topics} proj_dim={proj_dim} sample_rate="
             f"{sample_rate} iters={iters}")
    tm = importlib.import_module("bof_tpu_torch.apps.topic_model")
    rng = np.random.default_rng([SEED, 14])
    rows = np.sort(rng.choice(docs, N_SAMPLES, replace=False))
    r0 = int(rng.integers(0, docs - ASSIGN_ROWS))
    want_k2 = _csrmm_bands(a_sp.indptr, vocab, proj_dim)
    res, seen = {}, {}
    csrmm, lloyds_iter, lift_topics = tm.csrmm, km.lloyds_iter, \
        tm.lift_topics

    def csrmm_and_sample(a, b, c, **kw):
        # the projection as topic_model computes it, then the sampled
        # rows of P read back from its scratch file
        csrmm(a, b, c, **kw)
        seen["p"] = np.stack([c.read_block(int(r), 1, 0, proj_dim)[0]
                              for r in rows])

    def lloyds_and_sample(points, centers, labels_out=None, **kw):
        # the full assignment: the centers it is given and a run of P's
        # rows as it reads them
        if labels_out is not None and points.shape[0] == docs:
            seen["centers"] = np.array(centers, np.float32)
            seen["p_run"] = points.read_block(r0, ASSIGN_ROWS, 0, proj_dim)
        return lloyds_iter(points, centers, labels_out=labels_out, **kw)

    def lift_and_keep(*args, **kw):
        seen["lift"] = lift_topics(*args, **kw)
        return seen["lift"]

    def run(argv):
        t = time.perf_counter()
        tm.csrmm, km.lloyds_iter, tm.lift_topics = (
            csrmm_and_sample, lloyds_and_sample, lift_and_keep)
        try:
            res["out"] = tm_driver.main(argv)
        finally:
            tm.csrmm, km.lloyds_iter, tm.lift_topics = (csrmm, lloyds_iter,
                                                        lift_topics)
        return time.perf_counter() - t
    argv = [prefix, str(docs), str(vocab), str(n_topics), "--proj-dim",
            str(proj_dim), "--iters", str(iters), "--sample-rate",
            str(sample_rate), *_driver_args(dev, scratch)]
    wall, launches, stages, peak = _drive(
        dev, run, argv, profile=bool(os.environ.get("BOF_SMOKE_PROFILE")))
    others = {name: n for name, n in launches.items()
              if name.split("[")[0] not in ("spmm_ell", "lloyd_assign",
                                            "lloyd_accumulate")}
    if (launches["spmm_ell"] != want_k2 or launches["spmm_ell[f32]"]
            != want_k2 or not launches["lloyd_assign"]
            or not launches["lloyd_accumulate"] or any(others.values())):
        raise AssertionError(f"[{label}] launches {launches}, expected K2 "
                             f"{want_k2} (the projection's bands) and B7")
    _app_report(label, wall, 2.0 * a_sp.nnz * proj_dim * (iters + 2),
                launches, stages, peak, "topic.",
                ("project_s", "cluster_s", "assign_s", "lift_s"))
    _stages(label, stages, "kmeans.", ("seed_s", "disk_wait_s", "h2d_s",
                                       "d2h_s"))
    tw, labels = res["out"]
    t0 = time.perf_counter()
    r64 = (np.random.default_rng(0).standard_normal((vocab, proj_dim))
           / np.sqrt(proj_dim)).astype(np.float32)
    p64 = a_sp[rows].astype(np.float64) @ r64.astype(np.float64)
    row_max = int(np.diff(a_sp.indptr).max())
    atol = ATOL_SCALE * row_max ** 0.5 * float(np.abs(a_sp.data).max()) \
        * float(np.abs(r64).max())
    p_err = _verify(f"{label}: 16 rows of P = A R", [(seen["p"], p64)],
                    atol, "1e-5*sqrt(max nnz/row)*max|A|*max|R|")
    # B7 at this path's shapes (d 64, k 1000): the full assignment's
    # labels against the plain version on the same P rows and centers
    idx = np.concatenate([np.arange(r0, r0 + ASSIGN_ROWS), rows])
    p_t = torch.from_numpy(np.concatenate([seen["p_run"], seen["p"]])).to(dev)
    c_t = torch.from_numpy(seen["centers"]).to(dev)
    want_l, _ = km.lloyd_assign_ref(p_t, c_t, (c_t * c_t).sum(1))
    differ = _near_ties(f"{label}: assignment", p_t, c_t.double(),
                        torch.from_numpy(labels[idx]).to(dev), want_l)
    del p_t, c_t, want_l
    print(f"[{label}] P rows max abs err {p_err:.3g}; the full assignment's "
          f"labels of {len(idx)} rows against lloyd_assign_ref: {differ} "
          f"differ (all near-ties)", flush=True)
    _check_lift(label, a_sp, labels, seen["lift"], tw, n_topics)
    print(f"[{label}] checked in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def _check_lift(label, a_sp, labels, lift, tw, n_topics):
    """T1's lift gate: labels in [0, n_topics); the unnormalized lift
    (`lift_topics`' output) float64 one_hot(labels)^T A within rtol 1e-4,
    atol 1e-6; the topic-word matrix that lift over its float32 row sums
    within one rounding (2^-24 relative), zero where the float32 sum is
    <= 0, and where float32 and float64 disagree on a row sum's sign, the
    float64 sum within the float32 sum's rounding of 0."""
    import numpy as np
    vocab = a_sp.shape[1]
    if labels.min() < 0 or labels.max() >= n_topics:
        raise AssertionError(f"[{label}] a label outside [0, {n_topics})")
    # one_hot(labels)^T A in float64: each nonzero added into its doc's
    # topic row (np.bincount; the port's lift runs np.add.at here)
    flat = np.repeat(labels.astype(np.int64) * vocab,
                     np.diff(a_sp.indptr)) + a_sp.indices
    t64 = np.bincount(flat, weights=a_sp.data.astype(np.float64),
                      minlength=n_topics * vocab).reshape(n_topics, vocab)
    del flat
    l_err = float((np.abs(lift - t64) / (1e-4 * np.abs(t64) + 1e-6)).max())
    # the normalization apart: each row over its float32 sum (bof_tpu's
    # arithmetic), one float32 rounding of the quotient
    norm32 = lift.sum(axis=1, keepdims=True)
    q = lift.astype(np.float64) / np.where(norm32 > 0, norm32, 1.0)
    kept = (norm32 > 0)[:, 0]
    n_err = float((np.abs(tw[kept] - q[kept])
                   / (2.0 ** -24 * np.abs(q[kept]) + 1e-30)).max())
    zero_ok = not np.any(tw[~kept])
    norm64 = t64.sum(1)
    flip = kept != (norm64 > 0)
    room = np.log2(vocab) * 2.0 ** -24 * np.abs(t64).sum(1)
    flips_ok = bool((np.abs(norm64[flip]) <= room[flip]).all())
    ok = l_err <= 1 and n_err <= 1 and zero_ok and flips_ok
    print(f"[{label}] labels in [0, {n_topics}), {len(np.unique(labels))} "
          f"topics used; unnormalized lift against float64: worst "
          f"err/(1e-4*|T64| + 1e-6) {l_err:.4f}; topic-word against lift / "
          f"float32 row sum: worst err/(2^-24*|q|) {n_err:.4f}; rows zeroed "
          f"(row sum <= 0): {int((~kept).sum())} by float32, "
          f"{int((norm64 <= 0).sum())} by float64, {int(flip.sum())} differ "
          f"(each within the float32 sum's rounding of 0: {flips_ok}), "
          f"zeroed rows all 0: {zero_ok} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"[{label}] disagrees with float64")


def _row_cut(a_sp, rows, scratch, name):
    """The first `rows` documents of `a_sp` as a CSR triplet of their own
    (`name`.off/.col/.csr, written over spares' blocks); returns (prefix,
    the cut)."""
    import numpy as np
    a_cut = a_sp[:rows]
    prefix = os.path.join(scratch, name)
    for ext, arr in ((".off", a_cut.indptr.astype(np.int64)),
                     (".col", a_cut.indices.astype(np.int64)),
                     (".csr", a_cut.data.astype(np.float32))):
        _reuse(prefix + ext, arr.nbytes)
        with open(prefix + ext, "r+b") as f:
            arr.tofile(f)
    return prefix, a_cut


def _retire_triplet(prefix):
    for ext in (".off", ".col", ".csr"):
        _retire(prefix + ext)


def mesh_apps_phase(dev, scratch, a_sp, rows=1 << 17) -> list:
    """S14 on a row cut of S3's A (its first `rows` documents, all 2^17
    columns, written as a triplet of its own; E1 and T1 run on the whole
    matrix): block_lanczos_svd(mesh=) through `drivers.eigensolver
    --sharded` with E1's settings (64 values, one restart; every operator
    application two csrmm_sharded passes, K2), then in the same counted
    run the sharded one-pass operator (K2 on both halves, an all-gather of
    W a band, one all-reduce of U) on 8 columns of the returned V; and
    topic_model(mesh=) through `drivers.topic_model --sharded` with T1's
    (1000 topics, proj_dim 64, sample rate 0.1, 4 iterations: a
    csrmm_sharded projection, a one-card fit of the sample, one
    lloyds_iter_ooc_sharded assignment: K2, B7, all-reduces), each on a
    1 x 1 NCCL mesh.  Gates: E1's (U on 8 columns within rtol 1e-4, atol
    1e-5 max|U|, of float64; sigma_i^2 within rtol 1e-4 of |A v_i|^2 for
    the top 8; V orthonormal to 1e-5) and T1's (16 rows of P within the
    csrmm gate of float64; the assignment's labels of ASSIGN_ROWS rows
    against `lloyd_assign_ref` on the centers it was given, but at
    near-ties; T1's own lift gate, `_check_lift`: the unnormalized lift
    within rtol 1e-4, atol 1e-6, of the float64 one_hot(labels)^T A, the
    topic-word matrix that lift over its float32 row sums within one
    rounding, rows whose float32 sum is <= 0 all zero, and a row sum whose
    sign float32 and float64 disagree on within its rounding of 0).
    Launches: every K2 of the run inside csrmm_sharded (each call at least
    one; two calls an operator application) or the sharded one-pass
    operator; T1's K2 inside its csrmm_sharded projection, and B7's assign
    and accumulate inside the sharded assignment, besides the one-card fit
    of the sample."""
    import importlib
    import numpy as np
    import torch
    import bof_tpu_torch as bt
    import bof_tpu_torch.parallel as par
    from bof_tpu_torch.drivers import eigensolver as eig_driver
    from bof_tpu_torch.drivers import topic_model as tm_driver
    from bof_tpu_torch.ops import kmeans as km
    from bof_tpu_torch.parallel import make_mesh
    eig = importlib.import_module("bof_tpu_torch.apps.eigensolver")
    prefix, a_cut = _row_cut(a_sp, rows, scratch, "A_cut")
    m, k = a_cut.shape
    runs = []

    # -- block Lanczos, every application sharded
    n_vals = 64
    label = (f"S14 E1 eigensolver lanczos {m}x{k} nnz={a_cut.nnz} "
             f"n_vals={n_vals} restarts=1 sharded (1x1 NCCL mesh)")
    res = {}

    csr_calls, one_pass_calls = [], []

    def run_eig(argv):
        t = time.perf_counter()
        with _launches_inside(par, "csrmm_sharded", csr_calls):
            res["out"] = eig_driver.main(argv)
        ctx = _new_ctx(dev, scratch)
        try:
            A = bt.CsrFlashMatrix.map_files(prefix, (m, k), ctx=ctx)
            with _launches_inside(eig, "_apply_ata_one_pass_sharded",
                                  one_pass_calls):
                res["u"] = eig._apply_ata_one_pass_sharded(
                    A, res["out"][1][:, :8], make_mesh(device=str(dev)),
                    ctx)
        finally:
            ctx.destroy()
        return time.perf_counter() - t
    argv = [prefix, str(m), str(k), str(n_vals), "--iters", "1", "--solver",
            "lanczos", "--sharded", *_driver_args(dev, scratch)]
    wall, launches, stages, peak = _drive(dev, run_eig, argv)
    n_k2 = launches["spmm_ell"]
    _check_launches(label, launches, {"spmm_ell": n_k2,
                                      "spmm_ell[f32]": n_k2})
    # the one-pass operator counts as an application too
    n_apply = int(stages.get("eig.op_applies", 0)) - len(one_pass_calls)
    k2_csr = [call["spmm_ell"] for call in csr_calls]
    k2_one = [call["spmm_ell"] for call in one_pass_calls]
    print(f"[{label}] K2 launches inside the {len(k2_csr)} csrmm_sharded "
          f"calls: {sum(k2_csr)} (fewest in a call {min(k2_csr, default=0)}"
          f"); inside the sharded one-pass operator: {sum(k2_one)}; of "
          f"{n_k2} in the run", flush=True)
    if (n_apply < 1 or len(k2_csr) != 2 * n_apply or min(k2_csr) < 1
            or len(k2_one) != 1 or k2_one[0] < 2
            or sum(k2_csr) + sum(k2_one) != n_k2):
        raise AssertionError(
            f"[{label}] K2 did not run through the sharded path: "
            f"{len(k2_csr)} csrmm_sharded calls for {n_apply} Lanczos "
            f"operator applications, K2 launches {k2_csr} inside them and "
            f"{k2_one} inside the one-pass operator, {n_k2} in the run")
    _check_collectives(label, stages, {"all_gather": None, "all_reduce": 1})
    _app_report(label, wall, 4.0 * a_cut.nnz * n_vals, launches, stages,
                peak, "eig.", ("disk_wait_s", "prep_s", "transpose_s",
                               "h2d_s", "dispatch_s", "fold_s", "d2h_s"))
    sigma, v = res["out"]
    v8 = v[:, :8].astype(np.float64)
    orth = float(np.abs(v.T.astype(np.float64) @ v - np.eye(n_vals)).max())
    a64 = a_cut.astype(np.float64)
    w64 = a64 @ v8
    u64 = a64.T @ w64
    atol = 1e-5 * float(np.abs(u64).max())
    u_err = float((np.abs(res["u"] - u64) / (1e-4 * np.abs(u64)
                                              + atol)).max())
    av2 = (w64 * w64).sum(0)
    s_err = float((np.abs(sigma[:8] ** 2 - av2) / (1e-4 * av2)).max())
    ok = u_err <= 1.0 and s_err <= 1.0 and orth <= 1e-5
    print(f"[{label}] {int(stages.get('eig.op_applies', 0))} operator "
          f"applications (two csrmm_sharded passes each) and the sharded "
          f"one-pass operator on 8 columns: K2 {n_k2} launches; sigma[:4] "
          f"{sigma[:4].tolist()}; U on 8 columns: worst err/(1e-4*|U64| + "
          f"1e-5*max|U64|) {u_err:.4f}; sigma^2 against |A v|^2, top 8: "
          f"worst err/(1e-4*|A v|^2) {s_err:.4f}; max|V^T V - I| {orth:.3g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{label}] disagrees with float64")
    runs.append(launches)

    # -- the topic model, projection and assignment sharded
    n_topics, proj_dim = 1000, 64
    label = (f"S14 T1 topic_model {m}x{k} nnz={a_cut.nnz} topics={n_topics} "
             f"proj_dim={proj_dim} sample_rate=0.1 iters=4 sharded (1x1 "
             "NCCL mesh)")
    rng = np.random.default_rng([SEED, 15])
    p_rows = np.sort(rng.choice(m, N_SAMPLES, replace=False))
    r0 = int(rng.integers(0, m - ASSIGN_ROWS))
    seen = {}
    tm = importlib.import_module("bof_tpu_torch.apps.topic_model")
    assign, lift_topics = par.lloyds_iter_ooc_sharded, tm.lift_topics

    assign_calls, project_calls = [], []

    def assign_and_sample(points, centers, labels_out=None, **kw):
        seen["centers"] = np.array(centers, np.float32)
        seen["p"] = np.stack([points.read_block(int(r), 1, 0, proj_dim)[0]
                              for r in p_rows])
        seen["p_run"] = points.read_block(r0, ASSIGN_ROWS, 0, proj_dim)
        before = _launch_counts()
        try:
            return assign(points, centers, labels_out=labels_out, **kw)
        finally:
            after = _launch_counts()
            assign_calls.append({key: n - before.get(key, 0)
                                 for key, n in after.items()})

    def lift_and_keep(*args, **kw):
        seen["lift"] = lift_topics(*args, **kw)
        return seen["lift"]

    def run_tm(argv):
        t = time.perf_counter()
        par.lloyds_iter_ooc_sharded = assign_and_sample
        tm.lift_topics = lift_and_keep
        try:
            with _launches_inside(par, "csrmm_sharded", project_calls):
                res["tm"] = tm_driver.main(argv)
        finally:
            par.lloyds_iter_ooc_sharded, tm.lift_topics = assign, lift_topics
        return time.perf_counter() - t
    argv = [prefix, str(m), str(k), str(n_topics), "--proj-dim",
            str(proj_dim), "--iters", "4", "--sample-rate", "0.1",
            "--sharded", *_driver_args(dev, scratch)]
    wall, launches, stages, peak = _drive(dev, run_tm, argv)
    others = {name: c for name, c in launches.items()
              if name.split("[")[0] not in ("spmm_ell", "lloyd_assign",
                                            "lloyd_accumulate")}
    if (not launches["spmm_ell"] or not launches["lloyd_assign"]
            or not launches["lloyd_accumulate"] or any(others.values())):
        raise AssertionError(f"[{label}] launches {launches}, expected K2 "
                             "and B7 only")
    sharded = {"projection K2": [c["spmm_ell"] for c in project_calls],
               "assignment B7 assign": [c["lloyd_assign"]
                                        for c in assign_calls],
               "assignment B7 accumulate": [c["lloyd_accumulate"]
                                            for c in assign_calls]}
    print(f"[{label}] launches inside the sharded calls: {sharded}; K2 in "
          f"the run {launches['spmm_ell']}", flush=True)
    if (any(len(calls) != 1 or calls[0] < 1 for calls in sharded.values())
            or sharded["projection K2"][0] != launches["spmm_ell"]):
        raise AssertionError(f"[{label}] a kernel did not run through the "
                             f"sharded path: {sharded}")
    _check_collectives(label, stages, {"all_reduce": None})
    _app_report(label, wall, 2.0 * a_cut.nnz * proj_dim * 6, launches,
                stages, peak, "topic.",
                ("project_s", "cluster_s", "assign_s", "lift_s"))
    tw, labels = res["tm"]
    r64 = (np.random.default_rng(0).standard_normal((k, proj_dim))
           / np.sqrt(proj_dim)).astype(np.float32)
    p64 = a_cut[p_rows].astype(np.float64) @ r64.astype(np.float64)
    row_max = int(np.diff(a_cut.indptr).max())
    atol = ATOL_SCALE * row_max ** 0.5 * float(np.abs(a_cut.data).max()) \
        * float(np.abs(r64).max())
    _verify(f"{label}: 16 rows of P = A R", [(seen["p"], p64)], atol,
            "1e-5*sqrt(max nnz/row)*max|A|*max|R|")
    idx = np.concatenate([np.arange(r0, r0 + ASSIGN_ROWS), p_rows])
    p_t = torch.from_numpy(np.concatenate([seen["p_run"], seen["p"]])).to(dev)
    c_t = torch.from_numpy(seen["centers"]).to(dev)
    want_l, _ = km.lloyd_assign_ref(p_t, c_t, (c_t * c_t).sum(1))
    differ = _near_ties(f"{label}: assignment", p_t, c_t.double(),
                        torch.from_numpy(labels[idx]).to(dev), want_l)
    del p_t, c_t, want_l
    print(f"[{label}] the assignment's labels of {len(idx)} rows against "
          f"lloyd_assign_ref: {differ} differ (all near-ties)", flush=True)
    _check_lift(label, a_cut, labels, seen["lift"], tw, n_topics)
    runs.append(launches)
    _retire_triplet(prefix)
    return runs


# ------------------------------------------------- fp64 gemm and k-means

def f64_kernel_phase(dev) -> dict:
    """K1 'f64' (DMMA) against its float64 plain version on the card: all 8
    layouts at 8192^3 and at a ragged 1000x776x516 and 1001x777x517, alpha
    -1.5 and a non-zero C, each element within bof_tpu's scaled bound
    1e-12 * k * max|row of op(A)| * max|column of op(B)| * |alpha|
    (tests/test_gemm64.py:76-80); a second launch on the same inputs must
    give the same bits.
    At 1000x776x516 and 1001x777x517 each layout also runs through the
    entry point on operands whose leading dimensions are one more than
    their widths: odd at the first shape (the kernel's 8-byte copies), even
    at the second (16-byte copies, the last of each storage row reading one
    element and zero-filling the other).  At 8192^3 the median of 5
    CUDA-event times of the kernel on R/N/N, on S10's R/N/T and on R/N/N
    with leading dimension 8193, its plain version and torch.mm on float64
    (cuBLAS DGEMM, the library yardstick), and the bound."""
    import itertools

    import torch
    from bof_tpu_torch.ops.cuda_lib import build
    from bof_tpu_torch.ops.matmul_cuda import (accum_matmul,
                                               accum_matmul_ref, k1_variant)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    alpha = -1.5
    max_err = worst = 0.0
    timing = {}
    entry = build().bof_accum_matmul_f64
    stream = torch.cuda.current_stream(dev).cuda_stream

    def wider(x):
        """x copied into storage one column wider, NaN in that column
        (a kernel that read it would return NaN)."""
        full = torch.full((x.shape[0], x.shape[1] + 1), float("nan"),
                          dtype=x.dtype, device=x.device)
        full[:, :x.shape[1]] = x
        return full

    def check(label, got, want, lim):
        nonlocal max_err, worst
        diff = (got - want).abs()
        err, ratio = float(diff.max()), float((diff / lim).max())
        ok = ratio <= 1.0
        print(f"K1 f64 {label}: max|kernel-plain| {err:.6g}, worst "
              f"|kernel-plain| / (1e-12*k*max|A row|*max|B col|*|alpha|)"
              f" {ratio:.3g} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("K1 f64 disagrees with its plain version")
        max_err, worst = max(max_err, err), max(worst, ratio)

    for m, n, k in ((8192, 8192, 8192), (1000, 776, 516), (1001, 777, 517)):
        a_log, b_log, c_log = (torch.randn(s, generator=gen, device=dev,
                                           dtype=torch.float64)
                               for s in ((m, k), (k, n), (m, n)))
        lim_log = 1e-12 * k * abs(alpha) * (
            a_log.abs().amax(1)[:, None] * b_log.abs().amax(0)[None, :])
        for a_km, b_nk, c_nm in itertools.product((False, True), repeat=3):
            a = a_log.T.contiguous() if a_km else a_log
            b = b_log.T.contiguous() if b_nk else b_log
            c0 = c_log.T.contiguous() if c_nm else c_log
            lim = lim_log.T if c_nm else lim_log
            flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
            label = (f"{m}x{n}x{k} a_km={int(a_km)} b_nk={int(b_nk)} "
                     f"c_nm={int(c_nm)}")
            if k1_variant("highest", dtype=torch.float64) != "f64":
                raise AssertionError("k1_variant did not choose f64")
            before = accum_matmul.variant_launches["f64"]
            got = accum_matmul(c0.clone(), a, b, alpha, **flags)
            again = accum_matmul(c0.clone(), a, b, alpha, **flags)
            want = accum_matmul_ref(c0.clone(), a, b, alpha, **flags)
            torch.cuda.synchronize()
            if accum_matmul.variant_launches["f64"] != before + 2:
                raise AssertionError("the f64 count did not move")
            if not torch.equal(got, again):
                raise AssertionError(f"K1 f64 {label}: two launches differ")
            check(label + " (two launches bit-identical)", got, want, lim)
            del got, again
            if m != 8192:
                a_f, b_f, c_f = wider(a), wider(b), wider(c0)
                rc = entry(c_f.data_ptr(), a_f.data_ptr(), b_f.data_ptr(),
                           alpha, m, n, k, int(a_km), int(b_nk), int(c_nm),
                           a_f.shape[1], b_f.shape[1], c_f.shape[1], stream)
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"bof_accum_matmul_f64: CUDA error "
                                       f"{rc}")
                if not bool(torch.isnan(c_f[:, -1]).all()):
                    raise AssertionError("K1 f64 wrote past C's columns")
                check(label + f" leading dimensions {a_f.shape[1]}/"
                      f"{b_f.shape[1]}/{c_f.shape[1]}", c_f[:, :-1], want,
                      lim)
                del a_f, b_f, c_f
            del want
            if m == 8192 and not (a_km or c_nm):
                c_t = c0.clone()
                key = "ms_rnt" if b_nk else "ms"
                timing[key] = _median_ms(lambda: accum_matmul(
                    c_t, a, b, alpha, **flags))
                if not b_nk:
                    timing["plain_ms"] = _median_ms(lambda: accum_matmul_ref(
                        c_t, a, b, alpha, **flags))
                    timing["library_ms"] = _median_ms(lambda: torch.mm(a, b))
                    a_f, b_f = wider(a), wider(b)
                    timing["ms_odd_ld"] = _median_ms(lambda: entry(
                        c_t.data_ptr(), a_f.data_ptr(), b_f.data_ptr(), alpha,
                        m, n, k, 0, 0, 0, k + 1, n + 1, n, stream))
                    del a_f, b_f
                del c_t
        del a_log, b_log, c_log, lim_log, a, b, c0, lim
        torch.cuda.empty_cache()
    flop = 2.0 * 8192 ** 3
    bound, by = _bound(4 * 8192 ** 2 * 8, flop, FP64_FLOPS)
    print(f"K1 f64 8192^3, median of 5 CUDA-event times: kernel R/N/N "
          f"{timing['ms']:.3f} ms ({flop / timing['ms'] / 1e9:.1f} TFLOP/s),"
          f" R/N/T (S10's layout) {timing['ms_rnt']:.3f} ms, R/N/N with "
          f"leading dimension 8193 {timing['ms_odd_ld']:.3f} ms; plain "
          f"{timing['plain_ms']:.3f} ms, library torch.mm(float64) "
          f"{timing['library_ms']:.3f} ms; bound {bound:.3f} ms ({by}, "
          f"{FP64_FLOPS / 1e12:.0f} TFLOP/s), the kernel at "
          f"{100 * bound / timing['ms']:.1f} % of it and "
          f"{timing['ms'] / timing['library_ms']:.2f}x the library",
          flush=True)
    return {"max_abs_err": max_err, "max_err_over_limit": worst,
            "bound_ms": bound, "bound_by": by, **timing}


def _blobs(gen, dev, n, d, k, spread):
    """n points round k true centers drawn from N(0, 10^2), each point its
    center plus N(0, spread^2) noise, on the card; returns (points,
    true centers)."""
    import torch
    true = 10.0 * torch.randn((k, d), generator=gen, device=dev)
    lab = torch.randint(0, k, (n,), generator=gen, device=dev)
    return true[lab] + spread * torch.randn((n, d), generator=gen,
                                            device=dev), true


def _near_ties(label, p, c64, got, want) -> int:
    """Where two label vectors differ, the float64 partial distances of the
    two centers must be within 1e-5 * (|p|^2 + max|c|^2) of each other (a
    near-tie that fp32 may break either way); raises otherwise.  Returns
    how many labels differ."""
    import torch
    diff = (got != want).nonzero().flatten()
    if diff.numel():
        p64 = p[diff].double()
        pd = (c64 * c64).sum(1)[None, :] - 2.0 * p64 @ c64.T
        rows = torch.arange(diff.numel(), device=p.device)
        gap = (pd[rows, got[diff].long()] - pd[rows, want[diff].long()]).abs()
        scale = (p64 * p64).sum(1) + float((c64 * c64).sum(1).max())
        if not bool((gap <= 1e-5 * scale).all()):
            raise AssertionError(f"[{label}] a label differs beyond a "
                                 "near-tie")
    return int(diff.numel())


def _accumulate_check(label, p, labels, k) -> float:
    """lloyd_accumulate twice on the same labels against the order-faithful
    plain version (the same bits), index_add_ (sums within 1e-5 * sum|p|
    over each center's points) and exact counts; returns max|kernel -
    index_add_|."""
    import torch
    from bof_tpu_torch.ops.kmeans import (lloyd_accumulate,
                                          lloyd_accumulate_ordered_ref,
                                          lloyd_accumulate_ref)
    d, dev = p.shape[1], p.device
    sums, counts = [], []
    for fn in (lloyd_accumulate, lloyd_accumulate, lloyd_accumulate_ref,
               lloyd_accumulate_ordered_ref):
        s_, n_ = (torch.zeros((k, d), device=dev),
                  torch.zeros(k, dtype=torch.int32, device=dev))
        fn(p, labels, s_, n_)
        sums.append(s_)
        counts.append(n_)
    torch.cuda.synchronize()
    abs_sum = torch.zeros((k, d), dtype=torch.float64, device=dev)
    abs_sum.index_add_(0, labels.long(), p.double().abs())
    s_err = (sums[0].double() - sums[2].double()).abs()
    runs = bool(torch.equal(sums[0], sums[1]))
    ordered = bool(torch.equal(sums[0], sums[3]))
    exact = all(bool(torch.equal(counts[0], c)) for c in counts[1:])
    within = bool((s_err <= 1e-5 * abs_sum).all())
    print(f"[{label}] accumulate: counts exact {exact}; sums bit-equal to "
          f"the order-faithful plain version {ordered}, two runs "
          f"bit-identical {runs}, max|kernel-index_add_| "
          f"{float(s_err.max()):.6g} within 1e-5*sum|p| {within}",
          flush=True)
    if not (exact and ordered and runs and within):
        raise AssertionError(f"[{label}] lloyd_accumulate disagrees")
    return float(s_err.max())


def kmeans_kernel_phase(dev) -> dict:
    """B7 against its plain version on the card at S11's streamed block
    (bn 131072, d 128, k 1024), at a ragged 1000x33x7, at 65537x130x1000
    (d not a multiple of 4: the split pass's padded copy; k not a multiple
    of the 256-center tile) and at T1's sample 104857x64x1000 (d 64: two
    32-float K slices on the aligned route): labels equal but at near-ties (float64 gap
    between the two centers <= 1e-5 * (|p|^2 + max|c|^2)), mind within
    1e-5 * (|p|^2 + max|c|^2), and the same against the plain 3xTF32
    emulation; two assign launches bit-identical; on the kernel's
    labels the accumulate as `_accumulate_check` holds it (counts exact,
    sums bit-equal to the order-faithful plain version, within 1e-5 *
    sum|p| of index_add_, bit-identical from run to run), and so on S11's
    block with every point in one center, with half the centers empty, and
    at 100003 points (not a multiple of the 1024-label chunk) on k 5000
    centers (past the shared-memory count table).  At S11's block the
    median of 5 CUDA-event times of each kernel, its plain version, the
    library calls (no single PyTorch call computes B7: assign beside the
    pair torch.addmm then torch.min(dim=1), and its device time by kernel,
    split pass and product; accumulate beside index_add_
    of the sums, whose counts would be a second call) and each bound; the
    accumulate, its plain version and index_add_ also on the card alone
    (queued behind a sleep kernel), as in each other case."""
    import torch
    from bof_tpu_torch.ops.kmeans import (lloyd_accumulate,
                                          lloyd_accumulate_ref, lloyd_assign,
                                          lloyd_assign_ref,
                                          lloyd_assign_tf32x3_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    out = {"lloyd_assign": {"max_abs_err": 0.0},
           "lloyd_accumulate": {"max_abs_err": 0.0}}
    tc = out["lloyd_accumulate"]
    # S11's block, two ragged shapes, and T1's sample (2^20 / 10 rows of
    # the d 64 projection on its 1000 topics)
    for bn, d, k in ((131072, 128, 1024), (1000, 33, 7), (65537, 130, 1000),
                     (104857, 64, 1000)):
        p, true = _blobs(gen, dev, bn, d, k, 1.0)
        c = true + 0.5 * torch.randn((k, d), generator=gen, device=dev)
        cn = (c * c).sum(1)
        label = f"B7 {bn}x{d}x{k}"
        before = (lloyd_assign.launches, lloyd_accumulate.launches)
        labels, mind = lloyd_assign(p, c, cn)
        again = lloyd_assign(p, c, cn)
        torch.cuda.synchronize()
        if not (torch.equal(labels, again[0])
                and torch.equal(mind, again[1])):
            raise AssertionError(f"[{label}] two assign launches differ")
        del again
        c64 = c.double()
        scale = (p.double() ** 2).sum(1) + float((c64 * c64).sum(1).max())
        for what, ref in (("plain version", lloyd_assign_ref),
                          ("3xTF32 emulation", lloyd_assign_tf32x3_ref)):
            want_l, want_m = ref(p, c, cn)
            torch.cuda.synchronize()
            differ = _near_ties(label, p, c64, labels, want_l)
            m_err = (mind - want_m).double().abs()
            if not bool((m_err <= 1e-5 * scale).all()):
                raise AssertionError(f"[{label}] mind disagrees with the "
                                     f"{what}")
            print(f"[{label}] labels differing from the {what}'s: {differ} "
                  f"(all near-ties); max|mind-{what}| "
                  f"{float(m_err.max()):.6g}, max of it over (|p|^2 + "
                  f"max|c|^2) {float((m_err / scale).max()):.3g} (limit "
                  "1e-5); two launches bit-identical", flush=True)
            key = ("max_abs_err" if ref is lloyd_assign_ref else
                   "max_abs_err_tf32x3_emulation")
            ta = out["lloyd_assign"]
            ta[key] = max(ta.get(key, 0.0), float(m_err.max()))
            del want_l, want_m
            torch.cuda.empty_cache()
        tc["max_abs_err"] = max(tc["max_abs_err"],
                                _accumulate_check(label, p, labels, k))
        if (lloyd_assign.launches, lloyd_accumulate.launches) != (
                before[0] + 2, before[1] + 2):
            raise AssertionError(f"[{label}] the B7 counts did not move")
        if bn != 131072:
            continue
        idx = labels.long()
        s_t = torch.zeros((k, d), device=dev)
        n_t = torch.zeros(k, dtype=torch.int32, device=dev)
        ta = out["lloyd_assign"]
        ta["ms"] = _median_ms(lambda: lloyd_assign(p, c, cn))
        # a lone call includes the host's wrapper and three launches; on
        # the card alone (10 calls a sample behind a sleep) it does not
        ta["ms_queued"] = _median_ms(lambda: lloyd_assign(p, c, cn),
                                     inner=10, queued=True)
        ta["plain_ms"] = _median_ms(lambda: lloyd_assign_ref(p, c, cn))
        ta["library_ms"] = None
        ta["library_pair_ms"] = _median_ms(lambda: torch.min(
            torch.addmm(cn[None, :], p, c.T, alpha=-2.0), dim=1))
        # three TF32 passes of G = P C^T, as K1 'tf32x3''s bound counts
        ta["bound_ms"], ta["bound_by"] = _bound(
            (bn * d + k * d + k) * 4 + bn * 8, 3 * 2.0 * bn * k * d,
            TF32_FLOPS)
        ta["kernel_ms"] = _device_ms_by_kernel(
            lambda: lloyd_assign(p, c, cn), ASSIGN_KERNELS)
        print("B7 assign at S11's block, device ms a call by kernel "
              "(torch.profiler, 10 calls): " + ", ".join(
                  f"{name} {ms:.4f}" for name, ms in ta["kernel_ms"].items()),
              flush=True)
        # ms, plain_ms and library_ms time a lone call, as for every
        # kernel; the accumulate's five launches take the host longer than
        # the card, so each is also timed on the card alone (*_queued: 10
        # calls a sample, queued behind a sleep)
        for key, fn in (
                ("ms", lambda: lloyd_accumulate(p, labels, s_t, n_t)),
                ("plain_ms", lambda: lloyd_accumulate_ref(p, labels, s_t,
                                                          n_t)),
                ("library_ms", lambda: s_t.index_add_(0, idx, p))):
            tc[key] = _median_ms(fn)
            tc[key + "_queued"] = _median_ms(fn, inner=10, queued=True)
        tc["kernel_ms"] = _device_ms_by_kernel(
            lambda: lloyd_accumulate(p, labels, s_t, n_t), ACC_KERNELS)
        print("B7 accumulate at S11's block, device ms a call by kernel "
              "(torch.profiler, 10 calls): " + ", ".join(
                  f"{name} {ms:.4f}" for name, ms in tc["kernel_ms"].items()),
              flush=True)
        tc["library"] = "index_add_ of the sums (counts: one more call)"
        tc["bound_ms"], tc["bound_by"] = _bound(
            (bn * d + bn) * 4 + 2 * (k * d + k) * 4, float(bn * d),
            FP32_FLOPS)
        # the same block on other labels, then more centers than the
        # shared-memory count table holds
        cases = (("one center", p, torch.full_like(labels, 7), k),
                 ("half the centers empty", p, 2 * torch.randint(
                     0, k // 2, (bn,), generator=gen, device=dev,
                     dtype=torch.int32), k))
        p_odd = p[:100003]
        cases += (("100003 points, k 5000", p_odd, torch.randint(
            0, 5000, (len(p_odd),), generator=gen, device=dev,
            dtype=torch.int32), 5000),)
        for name, pts, lab, kk in cases:
            tc["max_abs_err"] = max(tc["max_abs_err"], _accumulate_check(
                f"B7 {len(pts)}x{d}x{kk}, {name}", pts, lab, kk))
            s_c = torch.zeros((kk, d), device=dev)
            n_c = torch.zeros(kk, dtype=torch.int32, device=dev)
            tc[f"ms_queued {name}"] = _median_ms(
                lambda: lloyd_accumulate(pts, lab, s_c, n_c), inner=4,
                queued=True)
            lab64 = lab.long()
            tc[f"library_ms_queued {name}"] = _median_ms(
                lambda: s_c.index_add_(0, lab64, pts), inner=4, queued=True)
            del s_c, n_c
        print(f"B7 at S11's block {bn}x{d}x{k}, median of 5 CUDA-event "
              f"times: lloyd_assign {ta['ms']:.4f} ms, on the card alone "
              f"{ta['ms_queued']:.4f} ms (plain "
              f"{ta['plain_ms']:.4f}, addmm+min {ta['library_pair_ms']:.4f};"
              f" bound {ta['bound_ms']:.4f} ms, {ta['bound_by']}, the kernel "
              f"at {100 * ta['bound_ms'] / ta['ms']:.1f} % a lone call, "
              f"{100 * ta['bound_ms'] / ta['ms_queued']:.1f} % on the card "
              "alone); "
              f"lloyd_accumulate a lone call {tc['ms']:.4f} ms (plain "
              f"{tc['plain_ms']:.4f}, index_add_ {tc['library_ms']:.4f}), "
              f"on the card alone {tc['ms_queued']:.4f} ms (plain "
              f"{tc['plain_ms_queued']:.4f}, index_add_ "
              f"{tc['library_ms_queued']:.4f}); bound {tc['bound_ms']:.4f} "
              f"ms, {tc['bound_by']}, the kernel at "
              f"{100 * tc['bound_ms'] / tc['ms']:.1f} % a lone call, "
              f"{100 * tc['bound_ms'] / tc['ms_queued']:.1f} % on the card "
              "alone; accumulate on the card alone "
              + ", ".join(f"{name} {tc['ms_queued ' + name]:.4f} ms "
                          f"(index_add_ {tc['library_ms_queued ' + name]:.4f})"
                          for name, *_ in cases), flush=True)
        del p, c, cn, labels, mind, cases, p_odd, s_t, n_t
        torch.cuda.empty_cache()
    return out


def _write_normals(path, shape, gen, dev, dtype):
    """A row-major file of standard normals made on the card in chunks of
    rows; returns each row's max|x| (numpy)."""
    import numpy as np
    import torch
    rows, cols = shape
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    line_max = np.empty(rows)
    _reuse(path, rows * cols * np.dtype(dtype).itemsize)
    with open(path, "r+b") as f:
        for r0 in range(0, rows, CHUNK):
            x = torch.randn((min(CHUNK, rows - r0), cols), generator=gen,
                            device=dev, dtype=tdt)
            line_max[r0:r0 + len(x)] = x.abs().amax(1).cpu().numpy()
            x.cpu().numpy().tofile(f)
    return line_max


def _copy_in_place(src, dst):
    """src's bytes over dst's blocks (dst at least as large): no new
    blocks, unlike a copy to a fresh file."""
    with open(src, "rb") as f, open(dst, "r+b") as g:
        shutil.copyfileobj(f, g, 64 << 20)


def gemm64_phase(dev, scratch) -> list:
    """S10: gemm 16384^3 float64, order R, N/T, alpha -1.5, beta 0.5,
    through `drivers.gemm --dtype float64` (O_DIRECT, the native engine):
    16 seeded rows and columns of C against float64 numpy within
    1e-12 * (k * max|A row| * max|B col| * |alpha| + |beta| * |C0|); eight
    K1 launches, all 'f64'.  Then S14's run of it with --sharded
    (gemm_sharded on a 1 x 1 NCCL mesh, K1 'f64' a shard, eight
    reduce-scatters) from the same C0, under the same gate."""
    import numpy as np
    import torch
    from bof_tpu_torch.drivers import gemm as gemm_driver
    m = n = k = 16384
    alpha, beta = -1.5, 0.5
    shape = (f"gemm {m}x{n}x{k} float64 order=R ta=N tb=T alpha={alpha} "
             f"beta={beta}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    paths = {x: os.path.join(scratch, f"{x}64.bin") for x in "ABC"}
    c0_path = paths["C"] + ".0"
    t0 = time.perf_counter()
    a_rmax = _write_normals(paths["A"], (m, k), gen, dev, np.float64)
    b_rmax = _write_normals(paths["B"], (n, k), gen, dev, np.float64)
    _write_normals(paths["C"], (m, n), gen, dev, np.float64)
    _reuse(c0_path, m * n * 8)
    _copy_in_place(paths["C"], c0_path)  # each run starts from C0
    rng = np.random.default_rng([SEED, 10])
    rows = np.sort(rng.choice(m, N_SAMPLES, replace=False))
    cols = np.sort(rng.choice(n, N_SAMPLES, replace=False))
    mm = {x: np.memmap(paths[x], np.float64, "r", shape=(16384, 16384))
          for x in "ABC"}
    c0_rows, c0_cols = np.array(mm["C"][rows]), np.array(mm["C"][:, cols])
    print(f"[S10 {shape}] operands written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # op(B) = B^T: C[rows] = A[rows] B^T and C[:, cols] = A B[cols]^T,
    # streamed in row chunks of B and of A
    a_rows = np.array(mm["A"][rows])
    b_cols = np.array(mm["B"][cols])
    want_rows = np.empty((N_SAMPLES, n))
    want_cols = np.empty((m, N_SAMPLES))
    for r0 in range(0, n, CHUNK):
        want_rows[:, r0:r0 + CHUNK] = a_rows @ np.asarray(
            mm["B"][r0:r0 + CHUNK]).T
        want_cols[r0:r0 + CHUNK] = np.asarray(mm["A"][r0:r0 + CHUNK]) \
            @ b_cols.T
    del mm
    runs = []
    for tag, sharded in (("S10", False), ("S14 S10", True)):
        label = f"{tag} {shape}" + (" sharded (1x1 NCCL mesh)" if sharded
                                    else "")
        if sharded:
            _copy_in_place(c0_path, paths["C"])
        argv = [paths["A"], paths["B"], paths["C"], str(m), str(n), str(k),
                "--ta", "N", "--tb", "T", "--alpha", repr(alpha), "--beta",
                repr(beta), "--dtype", "float64",
                *_driver_args(dev, scratch)] + (["--sharded"] if sharded
                                                 else [])
        wall, launches, stages, peak = _drive(
            dev, gemm_driver.main, argv,
            profile=bool(os.environ.get("BOF_SMOKE_PROFILE")) and not sharded)
        _check_launches(label, launches, {"accum_matmul": 8,
                                          "accum_matmul[f64]": 8})
        pre = "gemm_sharded." if sharded else "gemm."
        print(f"[{label}] wall {wall:.3f} s, "
              f"{2.0 * m * n * k / wall / 1e9:.1f} GFLOP/s, K1 launches "
              f"{launches['accum_matmul']} (= mB*nB*kB, all f64), peak "
              f"device memory {peak / 2**30:.2f} GiB, h2d "
              f"{stages[pre + 'h2d_bytes'] / 2**30:.3f} GiB", flush=True)
        if sharded:
            _check_collectives(label, stages, {"reduce_scatter": 8})
            _stages(label, stages, pre, ("disk_wait_s", "h2d_s", "d2h_s",
                                         "write_wait_s"))
        else:
            _stages(label, stages, pre,
                    ("disk_wait_s", "prep_s", "h2d_s", "c_read_s",
                     "tile_wait_s", "accum_wait_s", "d2h_s",
                     "write_wait_s"))
        c_out = np.memmap(paths["C"], np.float64, "r", shape=(m, n))
        checks = (
            (np.array(c_out[rows]), alpha * want_rows + beta * c0_rows,
             a_rmax[rows][:, None] * b_rmax[None, :], c0_rows),
            (np.array(c_out[:, cols]), alpha * want_cols + beta * c0_cols,
             a_rmax[:, None] * b_rmax[cols][None, :], c0_cols))
        del c_out
        worst = max_err = 0.0
        for got, want, scale, c0 in checks:
            if not np.isfinite(got).all():
                raise AssertionError(f"[{label}] non-finite values in the "
                                     "output")
            limit = 1e-12 * (k * abs(alpha) * scale + abs(beta) * np.abs(c0))
            worst = max(worst, float((np.abs(got - want) / limit).max()))
            max_err = max(max_err, float(np.abs(got - want).max()))
        print(f"[{label}] 16 rows and 16 columns against float64 numpy: max "
              f"abs err {max_err:.6g}, worst err / (1e-12*(k*max|A row|*"
              f"max|B col|*|alpha| + |beta|*|C0|)) {worst:.4f} "
              f"{'ok' if worst <= 1.0 else 'FAIL'}", flush=True)
        if worst > 1.0:
            raise AssertionError(f"[{label}] disagrees with float64 numpy")
        runs.append(launches)
    for path in list(paths.values()) + [c0_path]:
        _retire(path)
    return runs


def _write_blobs(path, n, d, k, gen, dev):
    """S11's points: blobs round k true centers drawn from N(0, 10^2),
    N(0, 1) noise per point, made on the card in chunks; fp32
    row-major."""
    import torch
    true = 10.0 * torch.randn((k, d), generator=gen, device=dev)
    _reuse(path, n * d * 4)
    with open(path, "r+b") as f:
        for r0 in range(0, n, 1 << 20):
            rows = min(1 << 20, n - r0)
            lab = torch.randint(0, k, (rows,), generator=gen, device=dev)
            x = true[lab] + torch.randn((rows, d), generator=gen, device=dev)
            x.cpu().numpy().tofile(f)


def _stream_check(label, pts, labels_path, centers, n, d, k, dev):
    """The fit's output against float64 on the card: labels of 65536
    seeded points against the float64 argmin to `centers` (near-ties
    allowed), and over all points the float64 inertia sum |p - c_label|^2
    and the float64 sums and counts of each label.  Returns (inertia64,
    sums64, abs_sums64, counts64), the last three on the card."""
    import numpy as np
    import torch
    P = np.memmap(pts, np.float32, "r", shape=(n, d))
    L = np.memmap(labels_path, np.int32, "r", shape=(n,))
    c64 = torch.from_numpy(centers).to(dev).double()
    idx = np.sort(np.random.default_rng([SEED, n]).choice(
        n, min(n, 65536), replace=False))
    p = torch.from_numpy(np.array(P[idx])).to(dev)
    got = torch.from_numpy(np.array(L[idx])).to(dev)
    pd = (c64 * c64).sum(1)[None, :] - 2.0 * p.double() @ c64.T
    differ = _near_ties(label, p, c64, got, pd.argmin(1).to(torch.int32))
    inertia = 0.0
    sums = torch.zeros((k, d), dtype=torch.float64, device=dev)
    abs_sums = torch.zeros_like(sums)
    counts = torch.zeros(k, dtype=torch.int64, device=dev)
    for r0 in range(0, n, 1 << 20):
        p = torch.from_numpy(np.array(P[r0:r0 + (1 << 20)])).to(dev).double()
        lab = torch.from_numpy(np.array(L[r0:r0 + (1 << 20)])).to(dev).long()
        if int(lab.min()) < 0 or int(lab.max()) >= k:
            raise AssertionError(f"[{label}] a label out of [0, k)")
        inertia += float(((p - c64[lab]) ** 2).sum())
        sums.index_add_(0, lab, p)
        abs_sums.index_add_(0, lab, p.abs())
        counts += torch.bincount(lab, minlength=k)
    print(f"[{label}] labels of {len(idx)} seeded points against the float64 "
          f"argmin: {differ} differ, all near-ties", flush=True)
    return inertia, sums, abs_sums, counts


def _check_rel(label, what, got, want, rtol):
    ok = abs(got - want) <= rtol * abs(want)
    print(f"[{label}] {what} {got!r} against float64 {want!r}: rel err "
          f"{abs(got - want) / abs(want):.3g} (rtol {rtol}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{label}] {what} disagrees")


def _check_step(label, new_c, old_c, counts_got, sums64, abs64, counts64):
    """A Lloyd step's centers against the float64 mean of the points under
    the kernel's labels: within 1e-5 of the mean |p| per element (an
    empty cluster keeps its center), and its counts exactly."""
    import numpy as np
    cnt = counts64.cpu().numpy()
    if not np.array_equal(np.asarray(counts_got, np.int64), cnt):
        raise AssertionError(f"[{label}] counts differ from the labels'")
    safe = np.maximum(cnt, 1)[:, None]
    want = np.where(cnt[:, None] > 0, sums64.cpu().numpy() / safe, old_c)
    tol = 1e-5 * (abs64.cpu().numpy() / safe) + 1e-30
    worst = float((np.abs(new_c - want) / tol).max())
    print(f"[{label}] centers against the float64 mean under the kernel's "
          f"labels: worst err / (1e-5 * mean|p|) {worst:.4f}; counts equal "
          f"{'ok' if worst <= 1.0 else 'FAIL'}", flush=True)
    if worst > 1.0:
        raise AssertionError(f"[{label}] centers disagree")


def kmeans_phase(dev, scratch) -> dict:
    """S11: drivers.kmeans on 2^24 seeded blob points, d 128, k 1024, fp32,
    3 iterations, --labels-out, O_DIRECT and the native engine: 8 GiB on
    disk, more than the device budget allows resident (3*n*d*4 = 24 GiB >
    12 GiB), so every pass streams 128 blocks of 131072 rows through the
    pin cache and B7 runs 128 * (3 passes + the final labels pass) times.
    Checked against float64: the labels (near-ties allowed), the inertia
    (rtol 1e-4); then one more Lloyd step from the returned centers,
    outside the counted run: its labels must be the fit's bit for bit, its
    counts exact, its centers the float64 mean under those labels."""
    import numpy as np
    import torch
    import bof_tpu_torch as bt
    from bof_tpu_torch.drivers import kmeans as kmeans_driver
    n, d, k, iters = 1 << 24, 128, 1024, 3
    label = f"S11 kmeans n={n} d={d} k={k} iters={iters} (streamed)"
    pts = os.path.join(scratch, "points.bin")
    lab_path = os.path.join(scratch, "labels.bin")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    t0 = time.perf_counter()
    _write_blobs(pts, n, d, k, gen, dev)
    print(f"[{label}] points written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    fit = {}

    def run(argv):
        t = time.perf_counter()
        fit["out"] = kmeans_driver.main(argv)
        return time.perf_counter() - t
    _reuse(lab_path, n * 4)
    argv = [pts, str(n), str(d), str(k), "--iters", str(iters), "--seed",
            str(SEED), "--labels-out", lab_path, *_driver_args(dev, scratch)]
    wall, launches, stages, peak = _drive(
        dev, run, argv, profile=bool(os.environ.get("BOF_SMOKE_PROFILE")))
    blocks = n // 131072
    want = blocks * (iters + 1)
    _check_launches(label, launches, {"lloyd_assign": want,
                                      "lloyd_accumulate": want})
    centers, inertia = fit["out"]
    print(f"[{label}] wall {wall:.3f} s, "
          f"{2.0 * n * d * k * (iters + 1) / wall / 1e9:.1f} GFLOP/s (4 "
          f"passes), B7 launches {launches['lloyd_assign']} + "
          f"{launches['lloyd_accumulate']} (= {blocks} blocks x {iters + 1} "
          f"passes each), peak device memory {peak / 2**30:.2f} GiB, h2d "
          f"{stages.get('kmeans.h2d_bytes', 0) / 2**30:.3f} GiB", flush=True)
    _stages(label, stages, "kmeans.", ("seed_s", "disk_wait_s", "h2d_s",
                                       "d2h_s"))
    t0 = time.perf_counter()
    inertia64, sums64, abs64, counts64 = _stream_check(
        label, pts, lab_path, centers, n, d, k, dev)
    _check_rel(label, "inertia", inertia, inertia64, 1e-4)
    ctx = _new_ctx(dev, scratch)
    _reuse(lab_path + ".4", n * 4)
    try:
        P = bt.map_array(pts, (n, d), np.float32, ctx=ctx)
        L4 = bt.map_array(lab_path + ".4", (n,), np.int32, create=True,
                          ctx=ctx)
        new_c, _, counts = bt.lloyds_iter(P, centers, labels_out=L4, ctx=ctx)
    finally:
        ctx.destroy()
    same = np.array_equal(np.fromfile(lab_path + ".4", np.int32),
                          np.fromfile(lab_path, np.int32))
    print(f"[{label}] one more Lloyd step: its labels are the fit's bit for "
          f"bit: {same}", flush=True)
    if not same:
        raise AssertionError(f"[{label}] the labels are not reproducible")
    _check_step(label, new_c, centers, counts, sums64, abs64, counts64)
    print(f"[{label}] checked in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for path in (pts, lab_path, lab_path + ".4"):
        _retire(path)
    return launches


def kmeans_resident_phase(dev, scratch) -> list:
    """S11b: the resident tier.  2^21 points (1 GiB, so 3*n*d*4 fits the
    device budget), the other settings as S11's, through kmeans_fit with
    random seeding (S11 pays for k-means++): once with the default budgets
    (the points upload once) and once with a 768 MiB host budget, below the
    panel, so the same fit streams every pass.  Both launch B7 16 * 4
    times; the link bytes are 1 and 4 panels; the centers and labels must
    match (tests/test_kmeans.py:80), the labels stand against float64."""
    import numpy as np
    import torch
    import bof_tpu_torch as bt
    n, d, k, iters = 1 << 21, 128, 1024, 3
    pts = os.path.join(scratch, "points_b.bin")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    _write_blobs(pts, n, d, k, gen, dev)
    runs, out = [], {}
    for tier, budget in (("resident", None), ("streamed", 768 << 20)):
        label = f"S11b kmeans n={n} d={d} k={k} iters={iters} ({tier})"
        lab_path = os.path.join(scratch, f"labels_{tier}.bin")
        _reuse(lab_path, n * 4)
        ctx = _new_ctx(dev, scratch)
        if budget is not None:
            ctx.config.program_budget = budget
        fit = {}

        def run(_):
            t = time.perf_counter()
            P = bt.map_array(pts, (n, d), np.float32, ctx=ctx)
            L = bt.map_array(lab_path, (n,), np.int32, create=True, ctx=ctx)
            fit["out"] = bt.kmeans_fit(P, k, n_iters=iters, seed=SEED,
                                       init="random", labels_out=L, ctx=ctx)
            return time.perf_counter() - t
        try:
            wall, launches, stages, peak = _drive(dev, run, None)
        finally:
            ctx.destroy()
        want = (n // 131072) * (iters + 1)
        _check_launches(label, launches, {"lloyd_assign": want,
                                          "lloyd_accumulate": want})
        h2d = stages.get("kmeans.h2d_bytes", 0)
        want_h2d = n * d * 4 * (1 if budget is None else iters + 1)
        print(f"[{label}] wall {wall:.3f} s, B7 launches "
              f"{launches['lloyd_assign']} + {launches['lloyd_accumulate']}, "
              f"h2d {h2d / 2**30:.3f} GiB (expected {want_h2d / 2**30:.3f}), "
              f"peak device memory {peak / 2**30:.2f} GiB", flush=True)
        if h2d != want_h2d:
            raise AssertionError(f"[{label}] the points crossed the link "
                                 f"{h2d} bytes, expected {want_h2d}")
        _stages(label, stages, "kmeans.", ("seed_s", "disk_wait_s", "h2d_s",
                                           "d2h_s"))
        out[tier] = fit["out"] + (np.fromfile(lab_path, np.int32),)
        if budget is None:
            inertia64 = _stream_check(label, pts, lab_path, fit["out"][0], n,
                                      d, k, dev)[0]
            _check_rel(label, "inertia", fit["out"][1], inertia64, 1e-4)
        _retire(lab_path)
        runs.append(launches)
    _resident_matches_streamed("S11b", out)
    runs += kmeans_sharded_phase(dev, scratch, pts, n, d, k, iters)
    _retire(pts)
    return runs


def _resident_matches_streamed(tag, out):
    import numpy as np
    (c_a, i_a, l_a), (c_b, i_b, l_b) = out["resident"], out["streamed"]
    ok = (np.allclose(c_a, c_b, rtol=1e-5, atol=1e-5)
          and np.array_equal(l_a, l_b) and abs(i_a - i_b) <= 1e-4 * abs(i_b))
    print(f"[{tag}] resident against streamed: centers within rtol 1e-5 "
          f"(bit-identical: {np.array_equal(c_a, c_b)}), labels equal, "
          f"inertia {i_a!r} / {i_b!r} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"[{tag}] the resident fit differs from the "
                             "streamed one")


def kmeans_sharded_phase(dev, scratch, pts, n, d, k, iters) -> list:
    """S14 on S11b's points: kmeans_fit_sharded on a 1 x 1 NCCL mesh,
    bof_tpu's k-means++ seeding (the mesh fit's only one), `iters`
    iterations, once resident (a device budget that holds the mesh fit's
    panel and one-hot, 3*n*(d+k)*4 bytes: one upload) and once streamed
    (half that budget: an upload a pass).  B7 and an all-reduce of the
    statistics a block.  Gate: one more sharded Lloyd pass from the
    returned centers (outside the counted run) writes labels that stand
    against the float64 argmin (near-ties), its inertia within rtol 1e-4
    of float64 and its centers the float64 mean under those labels; the
    two tiers give the same centers and labels."""
    import numpy as np
    import bof_tpu_torch as bt
    from bof_tpu_torch.parallel import (kmeans_fit_sharded,
                                        lloyds_iter_ooc_sharded, make_mesh)
    runs, out = [], {}
    panel = 3 * n * (d + k) * 4  # bof_tpu's residency test of the mesh fit
    for tier, hbm in (("resident", panel + (1 << 30)),
                      ("streamed", panel // 2)):
        label = (f"S14 S11b kmeans_fit_sharded n={n} d={d} k={k} "
                 f"iters={iters} ({tier}, 1x1 NCCL mesh)")
        lab_path = os.path.join(scratch, f"labels_sh_{tier}.bin")
        _reuse(lab_path, n * 4)
        ctx = _new_ctx(dev, scratch)
        ctx.config.hbm_budget = hbm
        fit = {}

        def run(_):
            t = time.perf_counter()
            P = bt.map_array(pts, (n, d), np.float32, ctx=ctx)
            fit["out"] = kmeans_fit_sharded(
                P, k, n_iters=iters, seed=SEED, tol=-1.0,
                mesh=make_mesh(device=str(dev)), ctx=ctx)
            return time.perf_counter() - t
        try:
            wall, launches, stages, peak = _drive(dev, run, None)
            blocks = launches["lloyd_assign"]
            _check_launches(label, launches, {"lloyd_assign": blocks,
                                              "lloyd_accumulate": blocks})
            _check_collectives(label, stages, {"all_reduce": None})
            h2d = stages.get("kmeans.h2d_bytes", 0)
            want_h2d = n * d * 4 * (1 if tier == "resident" else iters)
            print(f"[{label}] wall {wall:.3f} s, B7 launches {blocks} + "
                  f"{launches['lloyd_accumulate']}, h2d {h2d / 2**30:.3f} GiB "
                  f"(expected {want_h2d / 2**30:.3f}), peak device memory "
                  f"{peak / 2**30:.2f} GiB", flush=True)
            if h2d != want_h2d:
                raise AssertionError(f"[{label}] the points crossed the "
                                     f"link {h2d} bytes, expected {want_h2d}")
            _stages(label, stages, "kmeans.", ("seed_s",))
            centers, inertia = fit["out"]
            P = bt.map_array(pts, (n, d), np.float32, ctx=ctx)
            L = bt.map_array(lab_path, (n,), np.int32, create=True, ctx=ctx)
            new_c, inertia2, counts = lloyds_iter_ooc_sharded(
                P, centers, labels_out=L, mesh=make_mesh(device=str(dev)),
                ctx=ctx)
        finally:
            ctx.destroy()
        inertia64, sums64, abs64, counts64 = _stream_check(
            label, pts, lab_path, centers, n, d, k, dev)
        _check_rel(label, "inertia of one more pass", inertia2, inertia64,
                   1e-4)
        _check_step(label, new_c, centers, counts, sums64, abs64, counts64)
        out[tier] = (centers, inertia, np.fromfile(lab_path, np.int32))
        _retire(lab_path)
        runs.append(launches)
    _resident_matches_streamed("S14 S11b", out)
    return runs


def gemm_run_phase(dev, scratch) -> None:
    """drivers.gemm_run on the card for float32 and float64 with
    --ld-pad 5: all 8 configs against the in-memory twin (float64 numpy for
    float64) must pass, every K1 launch on the dtype's variant."""
    from bof_tpu_torch.drivers import gemm_run
    for dtype, variant in (("float32", "tf32x3"), ("float64", "f64")):
        label = f"gemm_run {dtype} --ld-pad 5"

        def run(argv):
            t = time.perf_counter()
            if gemm_run.main(argv) != 0:
                raise AssertionError(f"[{label}] not ALL PASS")
            return time.perf_counter() - t
        wall, launches, _, _ = _drive(dev, run, [
            "--dtype", dtype, "--ld-pad", "5", "--device", str(dev),
            "--scratch", scratch])
        steps = 8 * 4 * 3 * 4  # 8 configs of 512x384x448 at blk 128
        _check_launches(label, launches, {"accum_matmul": steps,
                                          f"accum_matmul[{variant}]": steps})
        print(f"[{label}] ALL PASS in {wall:.3f} s, K1 launches "
              f"{launches['accum_matmul']}, all {variant}", flush=True)


def _write_bits(path, bits):
    """`bits` (a card tensor) to `path` over a spare's blocks, in chunks."""
    _reuse(path, bits.numel() * bits.element_size())
    with open(path, "r+b") as f:
        for c0 in range(0, bits.numel(), 1 << 24):
            bits[c0:c0 + (1 << 24)].cpu().numpy().tofile(f)


def sort_phase(dev, scratch, n=1 << 29) -> dict:
    """S12: drivers.sort on 2^29 seeded float32 elements (2 GiB: N(0, 1)
    with duplicates, +-0, +-inf and NaNs of both signs with payloads,
    `_b10_bits`), sort_compute 'device', the default sort_blk_elems (32
    blocks), O_DIRECT, the 8 GiB pin cache; input and output written over
    spares.  Fails unless B10 launched once a phase-1 block and once a
    non-empty phase-3 bucket, and the output is, bit for bit, the input
    regenerated on the card and stably sorted by B10's keys (the whole
    out-of-core sort is stable under them) by torch.sort."""
    import numpy as np
    import torch
    import bof_tpu_torch as bt
    from bof_tpu_torch.drivers import sort as sort_driver
    from bof_tpu_torch.ops.sort_cuda import canonical_keys
    label = f"S12 sort n={n} float32 sort_compute=device"
    src, dst = (os.path.join(scratch, f"sort_{x}.bin") for x in ("in", "out"))
    gen = torch.Generator(device=dev)
    t0 = time.perf_counter()
    gen.manual_seed(SEED + 12)
    _write_bits(src, _b10_bits(gen, dev, n, np.float32))
    _reuse(dst, n * 4)
    torch.cuda.empty_cache()
    print(f"[{label}] input written in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def run(argv):
        t = time.perf_counter()
        with _configured(sort_driver, sort_compute="device"):
            sort_driver.main(argv)
        return time.perf_counter() - t
    wall, launches, stages, peak = _drive(
        dev, run, [src, dst, str(n), *_driver_args(dev, scratch)],
        profile=bool(os.environ.get("BOF_SMOKE_PROFILE")))
    blocks = int(stages["sort.blocks"])
    buckets = int(stages.get("sort.buckets", 0))
    _check_launches(label, launches, {"sort_block": blocks + buckets})
    if blocks != -(-n // bt.FlashConfig().sort_blk_elems):
        raise AssertionError(f"[{label}] {blocks} blocks, expected "
                             f"{n} / sort_blk_elems")
    print(f"[{label}] wall {wall:.3f} s, {16.0 * n / wall / 1e9:.2f} GB/s "
          f"(the driver's formula, 4 * n * 4 bytes), B10 launches "
          f"{launches['sort_block']} = {blocks} blocks + {buckets} buckets, "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)
    _stages(label, stages, "sort.", ("phase1_s", "phase2_s", "phase3_s",
                                     "block_sort_s", "h2d_s"))
    t0 = time.perf_counter()
    gen.manual_seed(SEED + 12)
    bits = _b10_bits(gen, dev, n, np.float32)
    order = torch.sort(canonical_keys(bits, np.float32), stable=True).indices
    want = bits[order]
    del order, bits
    got = torch.from_numpy(np.fromfile(dst, np.int32)).to(dev)
    same = bool(torch.equal(got, want))
    del got, want
    torch.cuda.empty_cache()
    print(f"[{label}] output bit for bit the stable sort of the input by "
          f"B10's keys: {same} (checked in {time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not same:
        raise AssertionError(f"[{label}] the output is not the stable sort")
    for path in (src, dst):
        _retire(path)
    return launches


def map_phase(dev, scratch, n=1 << 29) -> dict:
    """S13: drivers.map_reduce on 2^29 seeded |N(0, 1)| float32 elements
    (2 GiB, written over a spare; no NaNs, whose payload the card's sqrt
    would make canonical): torch.sqrt on the card in 32 blocks (B11, the
    caller's torch ops: no kernel of the port launches), then the host sum.
    Fails unless the output is np.sqrt of the input bit for bit and the
    sum is within rtol 1e-12 of the float64 sum in the reference's block
    order."""
    import numpy as np
    import torch
    import bof_tpu_torch as bt
    from bof_tpu_torch.drivers import map_reduce as mr_driver
    blk = bt.FlashConfig().map_blk_elems
    label = f"S13 map_reduce n={n} float32 sqrt + sum"
    src, dst = (os.path.join(scratch, f"map_{x}.bin") for x in ("in", "out"))
    gen = torch.Generator(device=dev)
    t0 = time.perf_counter()
    gen.manual_seed(SEED + 13 * 2)
    _write_bits(src, torch.randn(n, generator=gen, device=dev).abs_()
                .view(torch.int32))
    _reuse(dst, n * 4)
    torch.cuda.empty_cache()
    print(f"[{label}] input written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    res = {}

    def run(argv):
        t = time.perf_counter()
        res["sum"] = mr_driver.main(argv)
        return time.perf_counter() - t
    wall, launches, stages, peak = _drive(
        dev, run, [src, dst, str(n), *_driver_args(dev, scratch)],
        profile=bool(os.environ.get("BOF_SMOKE_PROFILE")))
    if any(launches.values()):
        raise AssertionError(f"[{label}] a port kernel launched: {launches}")
    print(f"[{label}] wall {wall:.3f} s (map and reduce), "
          f"{12.0 * n / wall / 1e9:.2f} GB/s (the driver's formulas: 2 * n * "
          f"4 bytes mapped, n * 4 reduced), peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    _stages(label, stages, "map.", ("h2d_s", "fn_d2h_s"))
    t0 = time.perf_counter()
    gen.manual_seed(SEED + 13 * 2)
    x = torch.randn(n, generator=gen, device=dev).abs_()
    total = 0.0
    same = True
    with open(dst, "rb") as f:
        for b0 in range(0, n, blk):
            want = np.sqrt(x[b0:b0 + blk].cpu().numpy())
            got = np.fromfile(f, np.float32, count=blk)
            same = same and np.array_equal(got.view(np.uint32),
                                           want.view(np.uint32))
            total = total + want.sum(dtype=np.float64)
    del x
    torch.cuda.empty_cache()
    rel = abs(res["sum"] - total) / abs(total)
    ok = same and rel <= 1e-12
    print(f"[{label}] output np.sqrt of the input bit for bit: {same}; sum "
          f"{float(res['sum'])!r} against float64 in block order "
          f"{float(total)!r} (rel "
          f"{rel:.3g}, limit 1e-12); checked in "
          f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"[{label}] disagrees with numpy")
    for path in (src, dst):
        _retire(path)
    return launches


# ------------------------------------ S15: the dry run, kill and resume

RESUME_N, RESUME_BLK = 8192, 2048  # 16 C superblocks of 4 K steps each
RESUME_KILL_AT = 4                 # journal lines before the SIGKILL


def dryrun_phase(dev) -> dict:
    """S15a: `bof_tpu_torch.dryrun.dryrun_multichip` over this machine's
    cards, in-process on S14's NCCL world (one rank here): its seven
    phases print a line each and raise at the first that misses its
    reference gate (__graft_entry__.py:62-248).  K1 (tf32x3 and f64), K2
    and B7 must each launch, and its collectives run."""
    import torch
    from bof_tpu_torch.dryrun import dryrun_multichip
    label = f"S15 dryrun_multichip({torch.cuda.device_count()})"

    def run(argv):
        t = time.perf_counter()
        dryrun_multichip(torch.cuda.device_count())
        return time.perf_counter() - t
    wall, launches, stages, peak = _drive(dev, run, [])
    shown = {k: n for k, n in launches.items() if n}
    print(f"[{label}] wall {wall:.3f} s, launches {shown}, peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    for name in ("accum_matmul[tf32x3]", "accum_matmul[f64]", "spmm_ell",
                 "lloyd_assign", "lloyd_accumulate"):
        if not launches.get(name):
            raise AssertionError(f"[{label}] {name} never launched")
    _check_collectives(label, stages, {"reduce_scatter": None,
                                       "all_reduce": None,
                                       "all_gather": None})
    return launches


def collective_timing(dev) -> None:
    """B13's collectives on S14's world of one NCCL rank at S14's shapes:
    gemm_sharded's reduce-scatter of an 8192 x 8192 fp32 partial over 'y'
    and kmeans_dp's all-reduce of S11b's statistics (k 1024, d 128: sums,
    counts and the inertia in float64), each the median of 5 CUDA-event
    samples of 10 calls, beside its bound (each byte read once and written
    once over the memory rate)."""
    import torch
    import torch.distributed as dist
    from bof_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device="cuda")
    part = torch.randn(8192, 8192, device=dev)
    out = torch.empty_like(part)  # 'y' has one rank: the whole partial
    stats = torch.randn(1024 * 128 + 1024 + 1, dtype=torch.float64,
                        device=dev)
    for name, fn, nbytes in (
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                out, part, group=mesh.get_group("y")), 2 * part.nbytes),
            ("all_reduce", lambda: dist.all_reduce(stats),
             2 * stats.nbytes)):
        ms = _median_ms(fn, inner=10)
        bound = nbytes / HBM_BPS * 1e3
        print(f"[B13 {name}] one NCCL rank, {nbytes // 2} bytes: {ms:.4f} "
              f"ms a call, bound {bound:.4f} ms (bytes; "
              f"{100 * bound / ms:.1f} %)", flush=True)
    del part, out, stats
    torch.cuda.empty_cache()


def _resume_worker(argv) -> int:
    """`chip_smoke.py --resume-worker A B C journal n blk`: one journaled
    fp32 gemm of the port on the card over existing files (O_DIRECT, the
    native engine; C written over its blocks), then `GEMM_DONE
    launches=<K1 launches in this process>`."""
    import numpy as np
    sys.path.insert(0, HERE)
    import bof_tpu_torch as bt
    from bof_tpu_torch.ops.gemm import gemm
    from bof_tpu_torch.ops.matmul_cuda import accum_matmul
    *paths, journal, n, blk = argv
    n, blk = int(n), int(blk)
    ctx = _new_ctx("cuda", os.path.join(os.path.dirname(journal),
                                        "scratch"))
    try:
        a, b, c = (bt.map_array(p, (n, n), np.float32, "R", ctx=ctx)
                   for p in paths)
        gemm(a, b, c, blk=blk, ctx=ctx, resume_journal=journal)
    finally:
        ctx.destroy()
    print(f"GEMM_DONE launches={accum_matmul.launches} tf32x3="
          f"{accum_matmul.variant_launches['tf32x3']}", flush=True)
    return 0


def _same_bytes(p, q) -> bool:
    with open(p, "rb") as f, open(q, "rb") as g:
        while True:
            x, y = f.read(64 << 20), g.read(64 << 20)
            if x != y:
                return False
            if not x:
                return True


def resume_phase(dev, scratch) -> None:
    """S15b: kill and resume a journaled gemm on the card.  A worker
    process (`--resume-worker`) runs 8192^2 x 8192 fp32 at blk 2048 (16 C
    superblocks of 4 K steps) uninterrupted; a second is SIGKILLed once
    its journal holds 4 lines, then started again.  Fails unless the
    resumed C is byte-identical to the uninterrupted one, the resumed run
    launches K1 (superblocks left) x 4 times and removes its journal, and
    16 seeded rows of C agree with float64 on the card."""
    import re
    import signal

    import numpy as np
    import torch
    from bof_tpu_torch.ops.gemm import _load_journal
    n, blk = RESUME_N, RESUME_BLK
    blocks, k_steps = (n // blk) ** 2, n // blk
    label = f"S15 gemm kill-and-resume {n}^3 blk {blk}"
    d = os.path.join(scratch, "resume")  # the journals, the workers' scratch
    os.makedirs(os.path.join(d, "scratch"), exist_ok=True)
    a, b, c_ref, c_kill = (os.path.join(scratch, f"resume_{x}.bin")
                           for x in ("A", "B", "C_ref", "C_kill"))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    a_max = _write_normals(a, (n, n), gen, dev, np.float32).max()
    b_max = _write_normals(b, (n, n), gen, dev, np.float32).max()
    for path in (c_ref, c_kill):
        _reuse(path, n * n * 4)
    print(f"[{label}] operands written in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def launch(c, journal):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--resume-worker",
             a, b, c, journal, str(n), str(blk)], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(proc, what):
        out, _ = proc.communicate(timeout=300)
        found = re.search(r"GEMM_DONE launches=(\d+)", out)
        if proc.returncode != 0 or not found:
            raise AssertionError(f"[{label}] {what} failed (rc "
                                 f"{proc.returncode}):\n{out[-3000:]}")
        return int(found.group(1))

    def lines(journal):
        """Whole lines after the header (a torn last line is not one)."""
        try:
            with open(journal) as f:
                return max(0, f.read().count("\n") - 1)
        except OSError:
            return 0

    t0 = time.perf_counter()
    full = finish(launch(c_ref, os.path.join(d, "journal_ref.txt")),
                  "the uninterrupted run")
    t_full = time.perf_counter() - t0
    if full != blocks * k_steps:
        raise AssertionError(f"[{label}] the uninterrupted run launched K1 "
                             f"{full} times, expected {blocks * k_steps}")
    journal = os.path.join(d, "journal_kill.txt")
    t0 = time.perf_counter()
    proc = launch(c_kill, journal)
    deadline = time.monotonic() + 300
    while proc.poll() is None and time.monotonic() < deadline:
        if lines(journal) >= RESUME_KILL_AT:
            proc.send_signal(signal.SIGKILL)
            break
        time.sleep(0.002)
    if proc.poll() is None:
        proc.kill()
    proc.communicate(timeout=60)
    t_kill = time.perf_counter() - t0
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"[{label}] the worker to kill ended by itself "
                             f"(rc {proc.returncode})")
    with open(journal) as f:
        done = len(_load_journal(journal, f.readline().rstrip("\n")))
    if not RESUME_KILL_AT <= done < blocks:
        raise AssertionError(f"[{label}] {done} superblocks durable at the "
                             f"kill, expected {RESUME_KILL_AT}..{blocks - 1}")
    t0 = time.perf_counter()
    resumed = finish(launch(c_kill, journal), "the resumed run")
    t_resume = time.perf_counter() - t0
    want = (blocks - done) * k_steps
    same = _same_bytes(c_kill, c_ref)
    print(f"[{label}] uninterrupted {t_full:.1f} s ({full} K1 launches); "
          f"killed after {t_kill:.1f} s with {done} of {blocks} superblocks "
          f"journaled; resumed in {t_resume:.1f} s with {resumed} K1 "
          f"launches (expected ({blocks} - {done}) x {k_steps} = {want}); "
          f"C byte-identical to the uninterrupted run: {same}", flush=True)
    if resumed != want or not same or os.path.exists(journal):
        raise AssertionError(f"[{label}] the resumed run is not the "
                             "uninterrupted one (launches, bytes or journal)")
    rows = np.sort(np.random.default_rng(SEED + 15).choice(
        n, N_SAMPLES, replace=False))
    a_rows = np.fromfile(a, np.float32).reshape(n, n)[rows]
    b64 = torch.from_numpy(np.fromfile(b, np.float32).reshape(n, n)).to(
        dev, torch.float64)
    want_rows = (torch.from_numpy(a_rows).to(dev, torch.float64)
                 @ b64).cpu().numpy()
    del b64
    got_rows = np.fromfile(c_ref, np.float32).reshape(n, n)[rows]
    atol = ATOL_SCALE * np.sqrt(n) * a_max * b_max
    _verify(label, [(got_rows, want_rows)], atol,
            f"{ATOL_SCALE} * sqrt(k) * max|A| * max|B|")
    for path in (a, b, c_ref, c_kill):
        _retire(path)
    shutil.rmtree(d)
    torch.cuda.empty_cache()


ACC_KERNELS = ("acc_hist_kernel", "acc_scan_kernel", "acc_offsets_kernel",
               "acc_scatter_kernel", "acc_sum_kernel")
ASSIGN_KERNELS = ("tf32_split_kernel", "lloyd_assign_kernel")
SORT_KERNELS = ("sort_hist_kernel", "sort_onesweep_kernel")
NO_SPILLS = ("accum_tf32_kernel", "accum_lowp_kernel",
             "accum_dgemm_kernel", "row_topk_kernel",
             "row_topk_reg_kernel") + ASSIGN_KERNELS + ACC_KERNELS \
    + SORT_KERNELS


def _ptxas_report(log: str) -> None:
    """Print what ptxas says of each kernel; raise if a tensor-core kernel
    (K1's fp32, low-precision or fp64 kernel), a B7 kernel, B8 or B10
    spills."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "warning", "C75")):
            print("ptxas:", line.strip())
        if "spill stores" in line and any(k in entry for k in NO_SPILLS) \
                and "0 bytes spill stores, 0 bytes spill loads" not in line:
            raise AssertionError(f"{entry} spills: {line.strip()}")
    sys.stdout.flush()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "bof_tpu_torch")):
        print(f"chip_smoke: no bof_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    print(_run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(_run([_nvcc(), "--version"]).splitlines()[-1], flush=True)
    # full fp32 for every torch matmul on this card (the plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False")
    dev = torch.device("cuda", 0)

    from bof_tpu_torch.io import native
    from bof_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    if native.load_library() is None:
        raise RuntimeError("the native I/O engine did not build")
    t1 = time.perf_counter()
    cuda_lib.build()
    t2 = time.perf_counter()
    print(f"built: native I/O engine {t1 - t0:.1f} s, CUDA kernels "
          f"{t2 - t1:.1f} s ({cuda_lib.BUILD_INFO['path']})")
    _ptxas_report(cuda_lib.BUILD_INFO.get("ptxas", ""))

    walls = {}

    def timed(tag, fn, *args, **kw):
        """fn(*args, **kw), its wall added to walls[tag]."""
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            walls[tag] = walls.get(tag, 0.0) + time.perf_counter() - t

    summary = {"accum_matmul": timed("kernels K1", kernel_phase, dev)}
    summary.update(timed("kernels K1", lowp_kernel_phase, dev))
    summary.update(timed("kernels K1", s8_i32_kernel_phase, dev,
                         summary["accum_matmul[s8]"]["ms"]))
    summary.update({**timed("kernels K2", ell_kernel_phase, dev),
                    **timed("kernels B8", topk_kernel_phase, dev),
                    **timed("kernels B10", sort_kernel_phase, dev)})

    scratch = os.environ.get("BOF_SCRATCH") or os.path.join(
        HERE, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    fstype = _run(["stat", "-f", "-c", "%T", scratch])
    free = shutil.disk_usage(scratch).free
    print(f"scratch {scratch}: filesystem {fstype}, "
          f"{free / 2**30:.1f} GiB free", flush=True)
    if fstype == "tmpfs":
        raise RuntimeError(f"scratch {scratch} is tmpfs, where O_DIRECT "
                           "fails; point BOF_SCRATCH at a disk")
    if free < MIN_FREE:
        raise RuntimeError(f"scratch {scratch} has {free / 2**30:.1f} GiB "
                           f"free, the run's peak needs "
                           f"{MIN_FREE / 2**30:.0f} GiB; point BOF_SCRATCH "
                           "at a larger disk")

    # the main paths: each call zeroes every count just before it and
    # reads them just after (_drive); the totals go to the summary.  The
    # transfer modes run on the operands of the fp32 call before them.
    f32 = ("float32", "float32")
    runs = timed("S1 S6", gemm_phase, dev, scratch, 32768, 32768, 32768,
                 "R", "N", "N", 1.0, 0.0,
                 (("S1", *f32), ("S6", "int8", "bfloat16")))
    # S14 (the sharded paths on a 1 x 1 NCCL mesh) runs on each cell's
    # files right after the cell: here fp32 and int8 on S2's
    runs += timed("S2 S7 S14", gemm_phase, dev, scratch, 12288, 12288,
                  12288, "C", "T", "N", 0.5, 2.0,
                  (("S2", *f32), ("S7", "bfloat16", "float32"),
                   ("S14 S2", *f32, True),
                   ("S14 S2", "int8", "float32", True)))
    prefix = os.path.join(scratch, "A_fig6")
    t0 = time.perf_counter()
    a_sp = timed("S3 A", _sparse_create, prefix, 1 << 20, 1 << 17, 131.072,
                 SEED + 3)
    print(f"[S3] A written by drivers.sparse_create in "
          f"{time.perf_counter() - t0:.1f} s: {a_sp.shape[0]}x{a_sp.shape[1]}"
          f", nnz {a_sp.nnz}", flush=True)
    runs += timed("S3 S8 S14", csrmm_fig6_phase, dev, scratch, prefix, a_sp,
                  (("S3", *f32), ("S8", "int8", "bfloat16"),
                   ("S14 S3", *f32, True)))
    runs += timed("S4 S4b", csrmm_trans_phase, dev, scratch,
                  (("S4", *f32), ("S4b", "bfloat16", "float32")))
    for tag, trans, xfer in (("S5", "N", "float32"), ("S5", "T", "float32"),
                             ("S9", "N", "bfloat16"), ("S9", "N", "int8")):
        runs.append(timed("S5 S9", csrgemv_phase, dev, scratch, prefix, a_sp,
                          trans, tag, xfer))
    # the paper's three applications on S3's A: X1 on all of it, E1 and
    # T1 on its first 2^19 documents (cut for the time limit)
    half_prefix, a_half = timed("E1 T1 cut", _row_cut, a_sp, 1 << 19,
                                scratch, "A_half")
    runs.append(timed("E1", eigensolver_phase, dev, scratch, half_prefix,
                      a_half))
    runs.append(timed("X1", xml_phase, dev, scratch, prefix, a_sp))
    runs.append(timed("T1", topic_phase, dev, scratch, half_prefix, a_half))
    _retire_triplet(half_prefix)
    del a_half
    runs.append(timed("S14 X1", xml_phase, dev, scratch, prefix, a_sp,
                      sharded=True))
    runs += timed("S14 E1+T1 cut", mesh_apps_phase, dev, scratch, a_sp)
    for ext in (".off", ".col", ".csr"):
        os.unlink(prefix + ext)
    del a_sp
    # float64 gemm and k-means: their kernels first, then their main paths
    summary["accum_matmul[f64]"] = timed("kernels f64 + B7",
                                         f64_kernel_phase, dev)
    summary.update(timed("kernels f64 + B7", kmeans_kernel_phase, dev))
    for tag, phase in (("S10", gemm64_phase), ("S11", kmeans_phase),
                       ("S11b", kmeans_resident_phase)):
        got = timed(tag, phase, dev, scratch)
        runs += got if isinstance(got, list) else [got]
    timed("gemm_run", gemm_run_phase, dev, scratch)
    # the sort and map/reduce primitives, over spares
    for tag, phase in (("S12", sort_phase), ("S13", map_phase)):
        runs.append(timed(tag, phase, dev, scratch))
    # S15 on S14's world of one NCCL rank, over spares: the dry run, B13's
    # collectives timed, then kill-and-resume
    runs.append(timed("S15 dryrun", dryrun_phase, dev))
    timed("S15 collectives", collective_timing, dev)
    timed("S15 resume", resume_phase, dev, scratch)
    shutil.rmtree(os.path.join(scratch, "spare"))
    print("phase walls (s, data making and checks included): " + ", ".join(
        f"{tag} {sec:.1f}" for tag, sec in walls.items()), flush=True)
    # each entry counts its own variant's launches: the fp32 kernels as
    # the fp32 calls ran them, the others as the transfer modes did
    counted = {"accum_matmul": "accum_matmul[tf32x3]",
               "spmm_ell": "spmm_ell[f32]", "spmv_ell": "spmv_ell[f32]"}
    for name in summary:
        summary[name]["launches"] = sum(r[counted.get(name, name)]
                                        for r in runs)
        if summary[name]["launches"] == 0:
            raise AssertionError(f"the main paths never launched {name}")
    # S14's world of one NCCL rank ends with the checks
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    meta = {
        "accum_matmul": ("bof_tpu_torch/csrc/matmul_tf32.cu",
                         "bof_tpu/ops/matmul_pallas.py:65"),
        "accum_matmul[bf16]": ("bof_tpu_torch/csrc/matmul_lowp.cu",
                               "bof_tpu/ops/matmul_pallas.py:65"),
        "accum_matmul[s8]": ("bof_tpu_torch/csrc/matmul_lowp.cu",
                             "bof_tpu/ops/device.py:136"),
        "accum_matmul[s8_i32]": ("bof_tpu_torch/csrc/matmul_lowp.cu",
                                 "bof_tpu/parallel/mesh.py:109"),
        "spmm_ell": ("bof_tpu_torch/csrc/spmm_ell.cu",
                     "bof_tpu/sparse/spmm_pallas.py:64"),
        "spmm_ell[bf16]": ("bof_tpu_torch/csrc/spmm_ell.cu",
                           "bof_tpu/sparse/spmm_pallas.py:64"),
        "spmm_ell[s8]": ("bof_tpu_torch/csrc/spmm_ell.cu",
                         "bof_tpu/sparse/spmm_device.py:22"),
        "spmv_ell": ("bof_tpu_torch/csrc/spmm_ell.cu",
                     "bof_tpu/sparse/spmm_device.py:89"),
        "spmv_ell[bf16]": ("bof_tpu_torch/csrc/spmm_ell.cu",
                           "bof_tpu/sparse/spmm_device.py:89"),
        "spmv_ell[s8]": ("bof_tpu_torch/csrc/spmm_ell.cu",
                         "bof_tpu/sparse/spmm_device.py:89"),
        "accum_matmul[f64]": ("bof_tpu_torch/csrc/matmul_f64.cu",
                              "bof_tpu/ops/gemm64.py:89"),
        "lloyd_assign": ("bof_tpu_torch/csrc/kmeans.cu",
                         "bof_tpu/ops/kmeans.py:40"),
        "lloyd_accumulate": ("bof_tpu_torch/csrc/kmeans.cu",
                             "bof_tpu/ops/kmeans.py:40"),
        "row_topk": ("bof_tpu_torch/csrc/topk.cu",
                     "bof_tpu/apps/xml_rank.py:48"),
        "sort_block": ("bof_tpu_torch/csrc/sort.cu",
                       "bof_tpu/ops/sort.py:135"),
    }
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": repl,
        **{key: summary[name][key] for key in keys},
        **{key: val for key, val in summary[name].items()
           if key not in keys}}
        for name, (source, repl) in meta.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-worker"]:
        sys.exit(_resume_worker(sys.argv[2:]))
    sys.exit(main())
