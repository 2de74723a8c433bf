#!/usr/bin/env python3
"""Drive bof_tpu_torch's out-of-core SGEMM and sparse paths once on one
CUDA card.

    python3 chip_smoke.py

Steps, each of which raises (exit code != 0) when it fails:

1. require a CUDA card; print nvidia-smi's name and power limit, the torch
   and CUDA versions and `nvcc --version`;
2. build the kernels from `bof_tpu_torch/csrc` (one nvcc per source, all
   at once) and print the build time and what ptxas reports;
3. kernel K1 (`accum_matmul`): first a probe that wgmma truncates tf32
   operands (what the 3xTF32 split assumes); then every variant against
   its plain PyTorch version for all 8 storage layouts, with alpha 1.5 and
   a non-zero starting C: the tensor-core variants at 8192^3 and at a
   ragged 1000x776x516 with 16-byte rows, 'highest' (3xTF32) within
   2e-4 * max|plain| and 'default' (one TF32 pass) within 2e-4 *
   max|emulation| of its truncating emulation and within 2^-10 * sqrt(k) *
   max|A| * max|B| * |alpha| of full fp32; the FFMA variant at a ragged
   1000x777x513 that TMA cannot describe, within 2e-4 * max|plain|.  At
   8192^3 R/N/N, the median of 5 CUDA-event times of each tier, the plain
   version, `addmm_` with TF32 off (the library yardstick) and on, and the
   FFMA variant; ptxas must report no spills for the tensor-core kernel;
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
   The SpMV runs 8 such bands, each checked.  At (a), and over the 8
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
9. after each call, 16 sampled rows and 16 sampled columns of C (the
   whole y for csrgemv) against float64 numpy/scipy with rtol 2e-4 and
   atol 1e-5 * sqrt(inner length) * max|A| * max|B| * |alpha|; each
   kernel's launch count against what the planner forms (K1: mB*nB*kB,
   every one on the 3xTF32 variant;
   K2 and the SpMV: the ELL bands, recomputed here from the offsets with
   fill_row_blocks + ell_row_ranges); for csrmm, that the writer did no
   host assembly (no `csrmm.assemble_s`) and downloaded each row block
   and column panel once (`csrmm.d2h_bytes`); the wall time, GFLOP/s,
   the driver's GB/s, stage seconds and peak device memory.

Operands are written from seeded generators under `$BOF_SCRATCH`
(default `build/chip_smoke` in this checkout), which must be a real
filesystem (O_DIRECT) with about 24 GiB free; every file is deleted after
its check.  TF32 is switched off, so every torch matmul here is full fp32
(but for the one timing that asks for it).
With BOF_SMOKE_PROFILE=1 the S1, S2 and S3 calls run under torch.profiler
and the device time by kernel (and a launch, for K1, K2 and the SpMV) and
the device's busy share are printed.

The line before the last is the kernel summary as JSON (each kernel's
time, plain and library times, and its bound: the larger of its bytes over
3.35 TB/s and its operations over the peak rate of their type); the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

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
CHUNK = 2048           # rows per chunk when streaming operands from disk
MIN_FREE = 24 << 30    # S3 holds A (1.65 GB), B (2 GiB) and C (16 GiB)


def _run(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({res.returncode}): "
                           f"{res.stderr.strip()}")
    return res.stdout.strip()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")


def _median_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """The median over `reps` samples of one call's time, each sample
    `inner` calls back to back between two CUDA events (so that the host's
    time to launch a short kernel hides behind the one before)."""
    import torch
    fn()  # warm-up (and first-launch costs)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


HBM_BPS = 3.35e12      # H100 SXM device memory, bytes/s (data sheet)
TF32_FLOPS = 495e12    # H100 SXM dense TF32 tensor cores, FLOP/s
FP32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores, FLOP/s


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
    """K1 against its plain versions on the card, every variant and
    layout; times at 8192^3; returns the summary."""
    import itertools

    import numpy as np
    import torch
    from bof_tpu_torch.ops.cuda_lib import build
    from bof_tpu_torch.ops.matmul_cuda import (accum_matmul,
                                               accum_matmul_ref,
                                               accum_matmul_tf32_ref,
                                               k1_variant)

    _tf32_probe(dev)
    rng = np.random.default_rng(SEED)
    alpha = 1.5
    worst = worst_default = 0.0
    timing = {}
    # (shape, precisions, whether k1_variant sends it to the tensor cores):
    # the main path's superblock, a ragged shape with 16-byte rows, and a
    # ragged shape that TMA cannot describe (the FFMA variant)
    cases = (((8192, 8192, 8192), ("highest", "default"), True),
             ((1000, 776, 516), ("highest", "default"), True),
             ((1000, 777, 513), ("highest",), False))
    for (m, n, k), precs, tensor_cores in cases:
        a_log = torch.from_numpy(
            rng.standard_normal((m, k), dtype=np.float32)).to(dev)
        b_log = torch.from_numpy(
            rng.standard_normal((k, n), dtype=np.float32)).to(dev)
        c_log = torch.from_numpy(
            rng.standard_normal((m, n), dtype=np.float32)).to(dev)
        for (a_km, b_nk, c_nm), prec in itertools.product(
                itertools.product((False, True), repeat=3), precs):
            a = a_log.T.contiguous() if a_km else a_log
            b = b_log.T.contiguous() if b_nk else b_log
            c0 = c_log.T.contiguous() if c_nm else c_log
            flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
            variant = k1_variant(a.shape[1], b.shape[1], prec)
            expect = ("ffma" if not tensor_cores else
                      "tf32x3" if prec == "highest" else "tf32")
            if variant != expect:
                raise AssertionError(f"k1_variant chose {variant} at "
                                     f"{m}x{n}x{k} {flags} {prec}")
            before = accum_matmul.variant_launches[variant]
            got = accum_matmul(c0.clone(), a, b, alpha, prec=prec, **flags)
            want = accum_matmul_ref(c0.clone(), a, b, alpha, **flags)
            torch.cuda.synchronize()
            if accum_matmul.variant_launches[variant] != before + 1:
                raise AssertionError(f"the {variant} count did not move")
            label = (f"{variant} {m}x{n}x{k} a_km={int(a_km)} "
                     f"b_nk={int(b_nk)} c_nm={int(c_nm)}")
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
            if (m, n, k) == (8192, 8192, 8192) and not (a_km or b_nk
                                                       or c_nm):
                c_t = c0.clone()
                key = "ms" if prec == "highest" else "ms_default"
                timing[key] = _median_ms(lambda: accum_matmul(
                    c_t, a, b, alpha, prec=prec, **flags))
                if prec == "highest":
                    timing["plain_ms"] = _median_ms(
                        lambda: accum_matmul_ref(c_t, a, b, alpha, **flags))
                    timing["library_ms"] = _median_ms(
                        lambda: c_t.addmm_(a, b, alpha=alpha))
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        timing["library_tf32_ms"] = _median_ms(
                            lambda: c_t.addmm_(a, b, alpha=alpha))
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
                    # the FFMA variant on the same operands, through its
                    # entry point (k1_variant sends 8192^3 to the tensor
                    # cores): the kernel this PR's variants replace
                    ffma = build().bof_accum_matmul_f32
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    timing["ffma_ms"] = _median_ms(lambda: ffma(
                        c_t.data_ptr(), a.data_ptr(), b.data_ptr(), alpha, m,
                        n, k, 0, 0, 0, k, n, n, stream))
                del c_t
            del got, want
        del a_log, b_log, c_log
        torch.cuda.empty_cache()
    flop = 2.0 * 8192 ** 3
    bound, by = _bound(4 * 8192 ** 2 * 4, 3 * flop, TF32_FLOPS)
    timing["bound_default_ms"] = _bound(4 * 8192 ** 2 * 4, flop,
                                        TF32_FLOPS)[0]
    print("K1 8192^3 canonical, median of 5 CUDA-event times: " + ", ".join(
        f"{key} {timing[key]:.3f} ms ({flop / timing[key] / 1e9:.1f} "
        "TFLOP/s)" for key in ("ms", "ms_default", "plain_ms", "library_ms",
                               "library_tf32_ms", "ffma_ms"))
        + f"; 3xTF32 bound {bound:.3f} ms ({by}), the kernel at "
        f"{100 * bound / timing['ms']:.1f} % of it; one-pass bound "
        f"{timing['bound_default_ms']:.3f} ms", flush=True)
    return {"max_abs_err": worst, "max_abs_err_default": worst_default,
            "bound_ms": bound, "bound_by": by, **timing}


def _write_operand(ctx, path, shape, order, rng):
    """Create `path` through the port's map_array and fill it with
    standard normals, one chunk of storage lines at a time; returns
    max|x|."""
    import numpy as np
    import bof_tpu_torch as bt
    arr = bt.map_array(path, shape, np.float32, order, create=True, ctx=ctx)
    lines, width = shape if order == "R" else (shape[1], shape[0])
    amax = 0.0
    for l0 in range(0, lines, CHUNK):
        nl = min(CHUNK, lines - l0)
        block = rng.standard_normal((nl, width), dtype=np.float32)
        amax = max(amax, float(np.abs(block).max()))
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
    """Write each (path, shape, order) through the port's map_array;
    returns max|x| of each."""
    ctx = _new_ctx(dev, scratch)
    try:
        return [_write_operand(ctx, path, shape, order, rng)
                for path, shape, order in specs]
    finally:
        ctx.destroy()


def _reset_launch_counts():
    from bof_tpu_torch.ops.matmul_cuda import reset_launch_counts
    from bof_tpu_torch.sparse.spmm_cuda import spmm_ell, spmv_ell
    reset_launch_counts()
    spmm_ell.launches = spmv_ell.launches = 0


def _launch_counts() -> dict:
    """Every kernel's launch count, and K1's by variant as
    'accum_matmul[<variant>]'."""
    from bof_tpu_torch.ops.matmul_cuda import accum_matmul
    from bof_tpu_torch.sparse.spmm_cuda import spmm_ell, spmv_ell
    counts = {"accum_matmul": accum_matmul.launches,
              "spmm_ell": spmm_ell.launches, "spmv_ell": spmv_ell.launches}
    counts.update((f"accum_matmul[{v}]", n)
                  for v, n in accum_matmul.variant_launches.items())
    return counts


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
    for name in ("accum_tf32_kernel", "spmm_ell_kernel", "spmv_ell_kernel"):
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


def _check_launches(label, launches, want):
    """Each kernel ran exactly as often as the planner says (0 for the
    kernels this path does not use)."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"[{label}] {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    if not any(launches.values()):
        raise AssertionError(f"[{label}] no kernel launched")


def _stages(label, snap, prefix, keys):
    print(f"[{label}] stage seconds (summed per thread): " + ", ".join(
        f"{key}={snap.get(prefix + key, 0.0):.3f}" for key in keys),
        flush=True)


def gemm_phase(dev, scratch, m, n, k, order, ta, tb, alpha, beta) -> dict:
    import numpy as np
    import bof_tpu_torch as bt
    from bof_tpu_torch.drivers import gemm as gemm_driver
    from bof_tpu_torch.utils import cdiv

    label = f"gemm {m}x{n}x{k} order={order} ta={ta} tb={tb} " \
            f"alpha={alpha} beta={beta}"
    rng = np.random.default_rng([SEED, m, n, k])
    paths = {x: os.path.join(scratch, f"{x}_{m}_{n}_{k}.bin") for x in "ABC"}
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
    print(f"[{label}] operands written in {time.perf_counter() - t0:.1f} s",
          flush=True)

    argv = [paths["A"], paths["B"], paths["C"], str(m), str(n), str(k),
            "--order", order, "--ta", ta, "--tb", tb,
            "--alpha", repr(alpha), "--beta", repr(beta), "--o-direct",
            "--io-backend", "native", "--device", str(dev),
            "--scratch", scratch]
    if beta == 0.0:
        argv.append("--create-c")
    wall, launches, stages, peak = _drive(
        dev, gemm_driver.main, argv,
        profile=bool(os.environ.get("BOF_SMOKE_PROFILE")))
    blk = bt.FlashConfig().gemm_blk_size
    steps = cdiv(m, blk) * cdiv(n, blk) * cdiv(k, blk)
    # every step on the tensor cores: the superblocks are zero-padded to blk
    _check_launches(label, launches, {"accum_matmul": steps,
                                      "accum_matmul[tf32x3]": steps})
    flop = 2.0 * m * n * k
    print(f"[{label}] wall {wall:.3f} s, {flop / wall / 1e9:.1f} GFLOP/s, "
          f"K1 launches {launches['accum_matmul']} (= mB*nB*kB, all "
          f"tf32x3), peak "
          f"device memory {peak / 2**30:.2f} GiB", flush=True)
    _stages(label, stages, "gemm.",
            ("disk_wait_s", "prep_s", "h2d_s", "c_read_s", "tile_wait_s",
             "accum_wait_s", "d2h_s", "write_wait_s"))

    op_a = _logical(paths["A"], a_shape, order)
    op_b = _logical(paths["B"], b_shape, order)
    op_a = op_a.T if ta == "T" else op_a
    op_b = op_b.T if tb == "T" else op_b
    want_rows, want_cols = _sampled_reference(op_a, op_b, rows, cols)
    c_out = _logical(paths["C"], (m, n), order)
    pairs = [(np.asarray(c_out[rows, :], np.float64),
              alpha * want_rows + beta * c0_rows),
             (np.asarray(c_out[:, cols], np.float64),
              alpha * want_cols + beta * c0_cols)]
    del op_a, op_b, c_out
    _verify(label, pairs, ATOL_SCALE * np.sqrt(k) * a_max * b_max
            * abs(alpha), f"{ATOL_SCALE}*sqrt(k)*max|A|*max|B|*|alpha|")
    for p in paths.values():
        if os.path.exists(p):
            os.unlink(p)
    return launches


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


def _ell_yardsticks(ja, va, counts, dense):
    """The bound of an ELL product over `dense` (B, or x) and the same
    band as a torch CSR matrix for the library call.  Bytes: the real
    slots' ja and va once, counts and rows once, the rows of `dense` that
    real slots reference once, the output once; operations: 2 per real
    slot and column, on the fp32 cores."""
    import torch
    real = (torch.arange(ja.shape[1], device=ja.device)[None, :]
            < counts[:, None])
    width = dense.shape[1] if dense.dim() == 2 else 1
    nnz = int(real.sum())
    used = int(torch.unique(ja[real].to(torch.int64)).numel())
    nbytes = (nnz * (ja.element_size() + 4) + ja.shape[0] * 8
              + (used + ja.shape[0]) * width * 4)
    bound, by = _bound(nbytes, 2.0 * nnz * width, FP32_FLOPS)
    rows = torch.arange(ja.shape[0], device=va.device)[:, None].expand_as(ja)
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[real], ja[real].to(torch.int64)]), va[real],
        size=(ja.shape[0], dense.shape[0]))
    return bound, by, coo.coalesce().to_sparse_csr()  # sorted, summed


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
                  peak):
    """Print the call's throughput and stages; raise unless the writer
    took the device path's shape: no host assembly (the bands wrote their
    rows in place, alpha applied by K2) and each row block and column
    panel downloaded once (c_rows * cb * npanels floats in all)."""
    import importlib
    import bof_tpu_torch as bt
    from bof_tpu_torch.utils import cdiv
    if "csrmm.assemble_s" in stages:
        raise AssertionError(f"[{label}] the device path assembled on the "
                             "host")
    cb = importlib.import_module("bof_tpu_torch.sparse.csrmm") \
        ._col_block_width(n, b_rows, bt.FlashConfig())
    want_d2h = c_rows * cb * cdiv(n, cb) * 4
    if stages.get("csrmm.d2h_bytes") != want_d2h:
        raise AssertionError(f"[{label}] downloaded "
                             f"{stages.get('csrmm.d2h_bytes')} bytes, not "
                             f"one row block a panel ({want_d2h})")
    gbytes = a_nnz * 12.0 + (b_rows + c_rows) * n * 4.0
    print(f"[{label}] wall {wall:.3f} s, {2.0 * a_nnz * n / wall / 1e9:.1f} "
          f"GFLOP/s, {gbytes / wall / 1e9:.2f} GB/s (the driver's bytes: "
          f"nnz*12 + (B + C)*4), K2 launches {launches['spmm_ell']} (= ELL "
          f"bands), peak device memory {peak / 2**30:.2f} GiB", flush=True)
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


def csrmm_fig6_phase(dev, scratch, prefix, a_sp, n=1 << 12) -> dict:
    """S3: csrmm 'N' at the paper's Fig. 6 shape, s = 1e-3."""
    import numpy as np
    from bof_tpu_torch.drivers import csrmm as csrmm_driver
    m, k = a_sp.shape
    label = f"S3 csrmm N {m}x{k}x{n} nnz={a_sp.nnz}"
    rng = np.random.default_rng([SEED, 3])
    b_path = os.path.join(scratch, "B_fig6.bin")
    c_path = os.path.join(scratch, "C_fig6.bin")
    t0 = time.perf_counter()
    b_max, = _write_operands(dev, scratch, [(b_path, (k, n), "R")], rng)
    print(f"[{label}] B written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    want_bands = _csrmm_bands(a_sp.indptr, k, n)
    print(f"[{label}] planner forms {want_bands} ELL bands (recomputed in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    argv = [prefix, str(m), str(k), b_path, str(n), c_path, "--create-c",
            *_driver_args(dev, scratch)]
    wall, launches, stages, peak = _drive(
        dev, csrmm_driver.main, argv,
        profile=bool(os.environ.get("BOF_SMOKE_PROFILE")))
    _check_launches(label, launches, {"spmm_ell": want_bands})
    _report_csrmm(label, wall, a_sp.nnz, k, m, n, launches, stages, peak)

    t0 = time.perf_counter()
    rows = np.sort(rng.choice(m, N_SAMPLES, replace=False))
    cols = np.sort(rng.choice(n, N_SAMPLES, replace=False))
    b = _logical(b_path, (k, n), "R")
    sub = a_sp[rows]
    used = np.unique(sub.indices)
    want_rows = sub[:, used].astype(np.float64) @ np.asarray(b[used],
                                                             np.float64)
    want_cols = a_sp.astype(np.float64) @ np.asarray(b[:, cols], np.float64)
    c_out = _logical(c_path, (m, n), "R")
    pairs = [(np.asarray(c_out[rows], np.float64), want_rows),
             (_sample_cols(c_out, cols), want_cols)]
    del b, c_out
    row_max = int(np.diff(a_sp.indptr).max())
    atol = ATOL_SCALE * row_max ** 0.5 * float(np.abs(a_sp.data).max()) \
        * b_max
    print(f"[{label}] reference computed in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    _verify(label, pairs, atol, "1e-5*sqrt(max nnz/row)*max|A|*max|B|")
    for p in (b_path, c_path):
        os.unlink(p)
    return launches


def csrmm_trans_phase(dev, scratch, m=65536, k=262144, n=999,
                      per_row=64.0) -> dict:
    """S4: csrmm 'T' through csrcsc scratch and the 'N' recursion (uint16
    indices, cb 999), alpha 0.5, beta 2 on a seeded column-major C."""
    import numpy as np
    from bof_tpu_torch.drivers import csrmm as csrmm_driver
    alpha, beta = 0.5, 2.0
    prefix = os.path.join(scratch, "A2")
    t0 = time.perf_counter()
    a_sp = _sparse_create(prefix, m, k, per_row, SEED + 4)
    label = f"S4 csrmm T {m}x{k}x{n} nnz={a_sp.nnz} order C"
    rng = np.random.default_rng([SEED, 4])
    b_path = os.path.join(scratch, "B2.bin")
    c_path = os.path.join(scratch, "C2.bin")
    b_max, _ = _write_operands(dev, scratch, [(b_path, (m, n), "C"),
                                              (c_path, (k, n), "C")], rng)
    at = a_sp.T.tocsr()
    want_bands = _csrmm_bands(at.indptr.astype(np.int64), m, n)
    rows = np.sort(rng.choice(k, N_SAMPLES, replace=False))
    cols = np.sort(rng.choice(n, N_SAMPLES, replace=False))
    c0 = _logical(c_path, (k, n), "C")
    c0_rows = np.asarray(c0[rows], np.float64)
    c0_cols = np.asarray(c0[:, cols], np.float64)
    del c0
    print(f"[{label}] operands written in {time.perf_counter() - t0:.1f} s; "
          f"planner forms {want_bands} ELL bands", flush=True)

    argv = [prefix, str(m), str(k), b_path, str(n), c_path, "--ta", "T",
            "--order-b", "C", "--alpha", repr(alpha), "--beta", repr(beta),
            *_driver_args(dev, scratch)]
    wall, launches, stages, peak = _drive(dev, csrmm_driver.main, argv)
    _check_launches(label, launches, {"spmm_ell": want_bands})
    _report_csrmm(label, wall, a_sp.nnz, m, k, n, launches, stages, peak)

    b64 = np.asarray(_logical(b_path, (m, n), "C"), np.float64)
    c_out = _logical(c_path, (k, n), "C")
    pairs = [(np.asarray(c_out[rows], np.float64),
              alpha * (at[rows] @ b64) + beta * c0_rows),
             (np.asarray(c_out[:, cols], np.float64),
              alpha * (at.astype(np.float64) @ b64[:, cols])
              + beta * c0_cols)]
    del c_out
    row_max = int(np.diff(at.indptr).max())
    atol = ATOL_SCALE * row_max ** 0.5 * float(np.abs(a_sp.data).max()) \
        * b_max * abs(alpha)
    _verify(label, pairs, atol,
            "1e-5*sqrt(max nnz/row of A^T)*max|A|*max|B|*|alpha|")
    for p in (b_path, c_path) + tuple(prefix + x
                                      for x in (".off", ".col", ".csr")):
        os.unlink(p)
    return launches


def csrgemv_phase(dev, scratch, prefix, a_sp, trans) -> dict:
    """S5: csrgemv on S3's A; the whole y against float64 scipy."""
    import numpy as np
    from bof_tpu_torch.drivers import csrgemv as csrgemv_driver
    m, k = a_sp.shape
    label = f"S5 csrgemv {trans} {m}x{k} nnz={a_sp.nnz}"
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
    wall, launches, stages, peak = _drive(dev, csrgemv_driver.main, argv)
    if trans == "N":
        _check_launches(label, launches, {"spmv_ell": want_bands})
    elif any(launches.values()):
        raise AssertionError(f"[{label}] 'T' runs on the host, but "
                             f"launched {launches}")
    print(f"[{label}] wall {wall:.3f} s, {2.0 * a_sp.nnz / wall / 1e9:.2f} "
          f"GFLOP/s, {a_sp.nnz * 12.0 / wall / 1e9:.2f} GB/s (the driver's "
          f"bytes: nnz*12), SpMV launches {launches['spmv_ell']}, peak "
          f"device memory {peak / 2**30:.2f} GiB", flush=True)
    _stages(label, stages, "csrgemv.", ("disk_wait_s", "prep_s", "h2d_s",
                                        "dispatch_s", "d2h_s", "compute_s"))
    y = np.fromfile(y_path, np.float32).astype(np.float64)
    op = a_sp.T if trans == "T" else a_sp
    want = op.astype(np.float64) @ x.astype(np.float64)
    inner = int(np.diff(op.tocsr().indptr).max())
    atol = ATOL_SCALE * inner ** 0.5 * float(np.abs(a_sp.data).max()) \
        * float(np.abs(x).max())
    _verify(label, [(y, want)], atol,
            "1e-5*sqrt(max nnz/row of op(A))*max|A|*max|x|")
    for p in (x_path, y_path):
        os.unlink(p)
    return launches


def _ptxas_report(log: str) -> None:
    """Print what ptxas says of each kernel; raise if the tensor-core
    kernel spills."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "warning")):
            print("ptxas:", line.strip())
        if "spill stores" in line and "accum_tf32_kernel" in entry \
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

    summary = {"accum_matmul": kernel_phase(dev), **ell_kernel_phase(dev)}

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
                           f"free, the Fig. 6 csrmm needs "
                           f"{MIN_FREE / 2**30:.0f} GiB; point BOF_SCRATCH "
                           "at a larger disk")

    # the main paths: each call zeroes every count just before it and
    # reads them just after (_drive); the totals go to the summary
    runs = [gemm_phase(dev, scratch, 32768, 32768, 32768, "R", "N", "N",
                       1.0, 0.0),
            gemm_phase(dev, scratch, 12288, 12288, 12288, "C", "T", "N",
                       0.5, 2.0)]
    prefix = os.path.join(scratch, "A_fig6")
    t0 = time.perf_counter()
    a_sp = _sparse_create(prefix, 1 << 20, 1 << 17, 131.072, SEED + 3)
    print(f"[S3] A written by drivers.sparse_create in "
          f"{time.perf_counter() - t0:.1f} s: {a_sp.shape[0]}x{a_sp.shape[1]}"
          f", nnz {a_sp.nnz}", flush=True)
    runs.append(csrmm_fig6_phase(dev, scratch, prefix, a_sp))
    runs.append(csrmm_trans_phase(dev, scratch))
    for trans in ("N", "T"):
        runs.append(csrgemv_phase(dev, scratch, prefix, a_sp, trans))
    for ext in (".off", ".col", ".csr"):
        os.unlink(prefix + ext)
    del a_sp
    for name in summary:
        summary[name]["launches"] = sum(r[name] for r in runs)
        if summary[name]["launches"] == 0:
            raise AssertionError(f"the main paths never launched {name}")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    meta = {
        "accum_matmul": ("bof_tpu_torch/csrc/matmul_tf32.cu",
                         "bof_tpu/ops/matmul_pallas.py:65"),
        "spmm_ell": ("bof_tpu_torch/csrc/spmm_ell.cu",
                     "bof_tpu/sparse/spmm_pallas.py:64"),
        "spmv_ell": ("bof_tpu_torch/csrc/spmm_ell.cu",
                     "bof_tpu/sparse/spmm_device.py:89"),
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
    sys.exit(main())
