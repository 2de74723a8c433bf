#!/usr/bin/env python3
"""Drive bof_tpu_torch's out-of-core SGEMM and sparse paths once on one
CUDA card.

    python3 chip_smoke.py

Steps, each of which raises (exit code != 0) when it fails:

1. require a CUDA card; print nvidia-smi's name and power limit, the torch
   and CUDA versions and `nvcc --version`;
2. build the kernels from `bof_tpu_torch/csrc` (one nvcc per source, all
   at once) and print the build time and what ptxas reports;
3. kernel K1 (`accum_matmul`) against its plain PyTorch version for all 8
   storage layouts at 8192^3 and at a ragged 1000x777x513, with alpha 1.5
   and a non-zero starting C; tolerance max|kernel - plain| <=
   2e-4 * max|plain|; the median of 5 CUDA-event times of both at 8192^3;
4. kernel K2 (`spmm_ell`) against its plain version at (a) the csrmm
   band shape rows 512, rmax 256, k 131072, cb 4096, int32 indices;
   (b) uint16 indices, k 65536, cb 999, rows 24, rmax 64; (c) a mega-row
   band rows 8, rmax 16384, cb 256; then the ELL SpMV (`spmv_ell`) at
   rows 16384, rmax 256, k 131072.  Tolerance max|kernel - plain| <=
   2e-4 * max|plain| + 1e-5 * sqrt(rmax) * max|va| * max|B|; the median
   of 5 CUDA-event times of both at (a) and at the SpMV shape;
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
   kernel's launch count against what the planner forms (K1: mB*nB*kB;
   K2 and the SpMV: the ELL bands, recomputed here from the offsets with
   fill_row_blocks + ell_row_ranges); the wall time, GFLOP/s, the
   driver's GB/s, stage seconds and peak device memory.

Operands are written from seeded generators under `$BOF_SCRATCH`
(default `build/chip_smoke` in this checkout), which must be a real
filesystem (O_DIRECT) with about 24 GiB free; every file is deleted after
its check.  TF32 is switched off, so every torch matmul here is full fp32.
With BOF_SMOKE_PROFILE=1 the S3 call runs under torch.profiler and the
device time by kernel and the device's busy share are printed.

The line before the last is the kernel summary as JSON; the last line is
{"ok": true, "device": {...}}.
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


def _median_ms(fn, reps: int = 5) -> float:
    import torch
    fn()  # warm-up (and first-launch costs)
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


def kernel_phase(dev) -> dict:
    """K1 against its plain version on the card; returns the summary."""
    import itertools

    import numpy as np
    import torch
    from bof_tpu_torch.ops.matmul_cuda import accum_matmul, accum_matmul_ref

    rng = np.random.default_rng(SEED)
    alpha = 1.5
    worst = 0.0
    timing = {}
    for (m, n, k) in ((8192, 8192, 8192), (1000, 777, 513)):
        a_log = torch.from_numpy(
            rng.standard_normal((m, k), dtype=np.float32)).to(dev)
        b_log = torch.from_numpy(
            rng.standard_normal((k, n), dtype=np.float32)).to(dev)
        c_log = torch.from_numpy(
            rng.standard_normal((m, n), dtype=np.float32)).to(dev)
        for a_km, b_nk, c_nm in itertools.product((False, True), repeat=3):
            a = a_log.T.contiguous() if a_km else a_log
            b = b_log.T.contiguous() if b_nk else b_log
            c0 = c_log.T.contiguous() if c_nm else c_log
            flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
            got = accum_matmul(c0.clone(), a, b, alpha, **flags)
            want = accum_matmul_ref(c0.clone(), a, b, alpha, **flags)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = err <= RTOL * scale
            print(f"K1 {m}x{n}x{k} a_km={int(a_km)} b_nk={int(b_nk)} "
                  f"c_nm={int(c_nm)}: max|kernel-plain| {err:.6g} "
                  f"(limit {RTOL * scale:.6g} = {RTOL}*max|plain|) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at {m}x{n}x{k} {flags}")
            worst = max(worst, err)
            if (m, n, k) == (8192, 8192, 8192) and not (a_km or b_nk
                                                       or c_nm):
                c_k, c_p = c0.clone(), c0.clone()
                timing["ms"] = _median_ms(
                    lambda: accum_matmul(c_k, a, b, alpha, **flags))
                timing["plain_ms"] = _median_ms(
                    lambda: accum_matmul_ref(c_p, a, b, alpha, **flags))
            del got, want
        del a_log, b_log, c_log
    torch.cuda.synchronize()
    flop = 2.0 * 8192 ** 3
    print(f"K1 8192^3 canonical: kernel {timing['ms']:.3f} ms "
          f"({flop / timing['ms'] / 1e9:.1f} TFLOP/s), plain "
          f"{timing['plain_ms']:.3f} ms "
          f"({flop / timing['plain_ms'] / 1e9:.1f} TFLOP/s), median of 5 "
          "CUDA-event times", flush=True)
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, **timing}


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


def _counters():
    from bof_tpu_torch.ops.matmul_cuda import accum_matmul
    from bof_tpu_torch.sparse.spmm_cuda import spmm_ell, spmv_ell
    return {"accum_matmul": accum_matmul, "spmm_ell": spmm_ell,
            "spmv_ell": spmv_ell}


def _drive(dev, fn, argv, profile=False):
    """One call of a driver's main on the main path: every kernel count
    is set to 0 just before it and read just after.  Returns (wall s,
    launches by kernel, METRICS snapshot, peak device bytes)."""
    import torch
    from bof_tpu_torch.utils import METRICS
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    METRICS.reset()
    torch.cuda.init()  # the allocator's statistics exist only after it
    torch.cuda.reset_peak_memory_stats(dev)
    if profile:
        wall = _profiled(fn, argv)
    else:
        wall = fn(argv)
    launches = {name: c.launches for name, c in counters.items()}
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
    wall, launches, stages, peak = _drive(dev, gemm_driver.main, argv)
    blk = bt.FlashConfig().gemm_blk_size
    _check_launches(label, launches, {
        "accum_matmul": cdiv(m, blk) * cdiv(n, blk) * cdiv(k, blk)})
    flop = 2.0 * m * n * k
    print(f"[{label}] wall {wall:.3f} s, {flop / wall / 1e9:.1f} GFLOP/s, "
          f"K1 launches {launches['accum_matmul']} (= mB*nB*kB), peak "
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

def _ell_tolerance(want, rmax, va_max, b_max):
    return RTOL * float(want.abs().max()) + ATOL_SCALE * rmax ** 0.5 \
        * va_max * b_max


def _random_ell(rng, rows, rmax, k, idt, fill_lo, dev):
    """An ELL block with padding slots (ja 0, va 0) past a random count
    in [fill_lo * rmax, rmax] per row."""
    import numpy as np
    import torch
    counts = rng.integers(int(fill_lo * rmax), rmax + 1, rows)
    ja = rng.integers(0, k, (rows, rmax)).astype(idt)
    va = rng.standard_normal((rows, rmax), dtype=np.float32)
    pad = np.arange(rmax)[None, :] >= counts[:, None]
    ja[pad] = 0
    va[pad] = 0.0
    return (torch.from_numpy(ja).to(dev), torch.from_numpy(va).to(dev),
            float(np.abs(va).max()))


def ell_kernel_phase(dev) -> dict:
    """K2 and the ELL SpMV against their plain versions on the card;
    returns {name: summary}."""
    import numpy as np
    import torch
    from bof_tpu_torch.sparse.spmm_cuda import (spmm_ell, spmm_ell_ref,
                                                spmv_ell, spmv_ell_ref)
    rng = np.random.default_rng([SEED, 2])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out = {}
    worst = 0.0
    for tag, rows, rmax, k, cb, idt in (
            ("a", 512, 256, 131072, 4096, np.int32),
            ("b", 24, 64, 65536, 999, np.uint16),
            ("c", 8, 16384, 131072, 256, np.int32)):
        ja, va, va_max = _random_ell(rng, rows, rmax, k, idt, 0.5, dev)
        b = torch.randn((k, cb), generator=gen, device=dev)
        b_max = float(b.abs().max())
        got = spmm_ell(b, ja, va)
        want = spmm_ell_ref(b, ja, va)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        limit = _ell_tolerance(want, rmax, va_max, b_max)
        print(f"K2 ({tag}) rows {rows} rmax {rmax} k {k} cb {cb} "
              f"{np.dtype(idt).name}: max|kernel-plain| {err:.6g} (limit "
              f"{limit:.6g} = {RTOL}*max|plain| + {ATOL_SCALE}*sqrt(rmax)"
              f"*max|va|*max|B|) {'ok' if err <= limit else 'FAIL'}",
              flush=True)
        if err > limit:
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"({tag})")
        worst = max(worst, err)
        if tag == "a":
            ms = _median_ms(lambda: spmm_ell(b, ja, va))
            plain_ms = _median_ms(lambda: spmm_ell_ref(b, ja, va))
            gathered = rows * rmax * cb * 4
            print(f"K2 (a): kernel {ms:.3f} ms ({gathered / ms / 1e6:.1f} "
                  f"GB/s of gathered B rows), plain {plain_ms:.3f} ms "
                  f"({gathered / plain_ms / 1e6:.1f} GB/s), median of 5 "
                  "CUDA-event times", flush=True)
            out["spmm_ell"] = {"ms": ms, "plain_ms": plain_ms}
        del got, want, b, ja, va
        torch.cuda.empty_cache()
    out["spmm_ell"]["max_abs_err"] = worst

    rows, rmax, k = 16384, 256, 131072
    ja, va, va_max = _random_ell(rng, rows, rmax, k, np.int32, 0.5, dev)
    x = torch.randn((k,), generator=gen, device=dev)
    got = spmv_ell(x, ja, va)
    want = spmv_ell_ref(x, ja, va)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    limit = _ell_tolerance(want, rmax, va_max, float(x.abs().max()))
    print(f"SpMV rows {rows} rmax {rmax} k {k} int32: max|kernel-plain| "
          f"{err:.6g} (limit {limit:.6g}) {'ok' if err <= limit else 'FAIL'}",
          flush=True)
    if err > limit:
        raise AssertionError("the SpMV kernel disagrees with its plain "
                             "version")
    ms = _median_ms(lambda: spmv_ell(x, ja, va))
    plain_ms = _median_ms(lambda: spmv_ell_ref(x, ja, va))
    print(f"SpMV: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, median of 5 "
          "CUDA-event times", flush=True)
    out["spmv_ell"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
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
    gbytes = a_nnz * 12.0 + (b_rows + c_rows) * n * 4.0
    print(f"[{label}] wall {wall:.3f} s, {2.0 * a_nnz * n / wall / 1e9:.1f} "
          f"GFLOP/s, {gbytes / wall / 1e9:.2f} GB/s (the driver's bytes: "
          f"nnz*12 + (B + C)*4), K2 launches {launches['spmm_ell']} (= ELL "
          f"bands), peak device memory {peak / 2**30:.2f} GiB", flush=True)
    _stages(label, stages, "csrmm.",
            ("disk_wait_s", "prep_s", "h2d_s", "dispatch_s", "d2h_s",
             "assemble_s", "c_read_s", "write_wait_s"))
    print(f"[{label}] d2h {stages.get('csrmm.d2h_bytes', 0) / 2**30:.2f} "
          "GiB", flush=True)


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
    for line in cuda_lib.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    sys.stdout.flush()

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
        "accum_matmul": ("bof_tpu_torch/csrc/matmul.cu",
                         "bof_tpu/ops/matmul_pallas.py:65"),
        "spmm_ell": ("bof_tpu_torch/csrc/spmm_ell.cu",
                     "bof_tpu/sparse/spmm_pallas.py:64"),
        "spmv_ell": ("bof_tpu_torch/csrc/spmm_ell.cu",
                     "bof_tpu/sparse/spmm_device.py:89"),
    }
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": repl,
        "launches": summary[name]["launches"],
        "max_abs_err": summary[name]["max_abs_err"],
        "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name, (source, repl) in meta.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
