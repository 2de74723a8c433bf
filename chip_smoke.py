#!/usr/bin/env python3
"""Drive bof_tpu_torch's out-of-core SGEMM once on one CUDA card.

    python3 chip_smoke.py

Steps, each of which raises (exit code != 0) when it fails:

1. require a CUDA card; print nvidia-smi's name and power limit, the torch
   and CUDA versions and `nvcc --version`;
2. build the kernels from `bof_tpu_torch/csrc` and print the build time
   and what ptxas reports;
3. kernel K1 (`accum_matmul`) against its plain PyTorch version for all 8
   storage layouts at 8192^3 and at a ragged 1000x777x513, with alpha 1.5
   and a non-zero starting C; tolerance max|kernel - plain| <=
   2e-4 * max|plain|; the median of 5 CUDA-event times of both at 8192^3;
4. the main path through the CLI entry point
   (`bof_tpu_torch.drivers.gemm.main`): m = n = k = 32768 fp32, order R,
   N/N, alpha 1, beta 0, O_DIRECT, the native I/O engine, default blk
   (8192) and budgets (8 GiB host pin cache, 12 GiB device tile budget);
5. a second call at m = n = k = 12288 (ragged superblocks): order C,
   ta T, tb N, alpha 0.5, beta 2;
6. after each call, 16 sampled rows and 16 sampled columns of C against
   float64 numpy, K1's launch count against mB*nB*kB, and the wall time,
   GFLOP/s, stage seconds and peak device memory.

Operands are written through the port's own `map_array(create=True)` from
`np.random.default_rng(seed)`, under `$BOF_SCRATCH` (default `build/chip_smoke`
in this checkout), which must be a real filesystem (O_DIRECT) with about
16 GiB free.  TF32 is switched off, so every torch matmul here is full fp32.

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
MIN_FREE = 16 << 30


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


def gemm_phase(dev, scratch, m, n, k, order, ta, tb, alpha, beta,
               blk=None) -> dict:
    import numpy as np
    import torch
    import bof_tpu_torch as bt
    from bof_tpu_torch.drivers import gemm as gemm_driver
    from bof_tpu_torch.ops.matmul_cuda import accum_matmul
    from bof_tpu_torch.utils import METRICS, cdiv

    label = f"gemm {m}x{n}x{k} order={order} ta={ta} tb={tb} " \
            f"alpha={alpha} beta={beta}"
    rng = np.random.default_rng([SEED, m, n, k])
    paths = {x: os.path.join(scratch, f"{x}_{m}_{n}_{k}.bin") for x in "ABC"}
    a_shape = (k, m) if ta == "T" else (m, k)
    b_shape = (n, k) if tb == "T" else (k, n)
    t0 = time.perf_counter()
    ctx = bt.FlashContext(bt.FlashConfig(
        device=str(dev), io_backend="native", use_o_direct=True,
        scratch_dir=scratch))
    try:
        a_max = _write_operand(ctx, paths["A"], a_shape, order, rng)
        b_max = _write_operand(ctx, paths["B"], b_shape, order, rng)
        if beta != 0.0:
            _write_operand(ctx, paths["C"], (m, n), order, rng)
    finally:
        ctx.destroy()
    rows = np.sort(rng.choice(m, N_SAMPLES, replace=False))
    cols = np.sort(rng.choice(n, N_SAMPLES, replace=False))
    c0_rows = c0_cols = 0.0
    if beta != 0.0:
        c0 = _logical(paths["C"], (m, n), order)
        c0_rows = np.asarray(c0[rows, :], np.float64)
        c0_cols = np.asarray(c0[:, cols], np.float64)
        del c0
    print(f"[{label}] operands written in {time.perf_counter() - t0:.1f} s "
          f"({sum(os.path.getsize(p) for p in paths.values() if os.path.exists(p)) / 2**30:.2f} GiB)",
          flush=True)

    argv = [paths["A"], paths["B"], paths["C"], str(m), str(n), str(k),
            "--order", order, "--ta", ta, "--tb", tb,
            "--alpha", repr(alpha), "--beta", repr(beta), "--o-direct",
            "--io-backend", "native", "--device", str(dev),
            "--scratch", scratch]
    if beta == 0.0:
        argv.append("--create-c")
    if blk is not None:
        argv += ["--blk", str(blk)]
    on_card = dev.type == "cuda"
    METRICS.reset()
    if on_card:
        torch.cuda.init()  # the allocator's statistics exist only after it
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = accum_matmul.launches
    wall = gemm_driver.main(argv)
    launches = accum_matmul.launches - launches0
    stages = METRICS.snapshot()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    blk = blk or bt.FlashConfig().gemm_blk_size
    want_launches = cdiv(m, blk) * cdiv(n, blk) * cdiv(k, blk)
    if launches != want_launches:
        raise AssertionError(f"[{label}] K1 launched {launches} times, "
                             f"expected mB*nB*kB = {want_launches}")
    flop = 2.0 * m * n * k
    print(f"[{label}] wall {wall:.3f} s, {flop / wall / 1e9:.1f} GFLOP/s, "
          f"K1 launches {launches} (= mB*nB*kB), peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    keys = ("disk_wait_s", "prep_s", "h2d_s", "c_read_s", "tile_wait_s",
            "accum_wait_s", "d2h_s", "write_wait_s")
    print(f"[{label}] stage seconds (summed per thread): " + ", ".join(
        f"{key}={stages.get('gemm.' + key, 0.0):.3f}" for key in keys)
        + f", h2d_GiB={stages.get('gemm.h2d_bytes', 0.0) / 2**30:.2f}, "
        f"d2h_GiB={stages.get('gemm.d2h_bytes', 0.0) / 2**30:.2f}",
        flush=True)

    t0 = time.perf_counter()
    op_a = _logical(paths["A"], a_shape, order)
    op_b = _logical(paths["B"], b_shape, order)
    op_a = op_a.T if ta == "T" else op_a
    op_b = op_b.T if tb == "T" else op_b
    want_rows, want_cols = _sampled_reference(op_a, op_b, rows, cols)
    want_rows = alpha * want_rows + beta * c0_rows
    want_cols = alpha * want_cols + beta * c0_cols
    c_out = _logical(paths["C"], (m, n), order)
    got_rows = np.asarray(c_out[rows, :], np.float64)
    got_cols = np.asarray(c_out[:, cols], np.float64)
    atol = ATOL_SCALE * np.sqrt(k) * a_max * b_max * abs(alpha)
    worst = 0.0
    for got, want in ((got_rows, want_rows), (got_cols, want_cols)):
        if not np.isfinite(got).all():
            raise AssertionError(f"[{label}] non-finite values in C")
        excess = np.abs(got - want) / (RTOL * np.abs(want) + atol)
        worst = max(worst, float(excess.max()))
    max_err = max(float(np.abs(got_rows - want_rows).max()),
                  float(np.abs(got_cols - want_cols).max()))
    print(f"[{label}] verified {N_SAMPLES} rows + {N_SAMPLES} columns vs "
          f"float64 numpy in {time.perf_counter() - t0:.1f} s: max abs err "
          f"{max_err:.6g}, worst err/(rtol*|ref| + atol) {worst:.4f} "
          f"(rtol {RTOL}, atol {atol:.6g} = {ATOL_SCALE}*sqrt(k)*max|A|"
          f"*max|B|*|alpha|)", flush=True)
    del op_a, op_b, c_out
    if worst > 1.0:
        raise AssertionError(f"[{label}] C disagrees with the float64 "
                             "reference")
    for p in paths.values():
        if os.path.exists(p):
            os.unlink(p)
    return {"launches": launches, "wall_s": wall}


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
    from bof_tpu_torch.ops import matmul_cuda
    t0 = time.perf_counter()
    if native.load_library() is None:
        raise RuntimeError("the native I/O engine did not build")
    t1 = time.perf_counter()
    matmul_cuda.build()
    t2 = time.perf_counter()
    print(f"built: native I/O engine {t1 - t0:.1f} s, CUDA kernels "
          f"{t2 - t1:.1f} s ({matmul_cuda.BUILD_INFO['path']})")
    for line in matmul_cuda.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    sys.stdout.flush()

    k1 = kernel_phase(dev)

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
                           f"free, the 32768^3 run needs "
                           f"{MIN_FREE / 2**30:.0f} GiB; point BOF_SCRATCH "
                           "at a larger disk")

    # the main path: counts start at 0 here and are read after both calls
    matmul_cuda.accum_matmul.launches = 0
    gemm_phase(dev, scratch, 32768, 32768, 32768, "R", "N", "N", 1.0, 0.0)
    gemm_phase(dev, scratch, 12288, 12288, 12288, "C", "T", "N", 0.5, 2.0)
    launches = matmul_cuda.accum_matmul.launches
    if launches == 0:
        raise AssertionError("the main path never launched K1")

    print(json.dumps({"kernels": [{
        "name": "accum_matmul", "route": "cuda",
        "source": "bof_tpu_torch/csrc/matmul.cu",
        "replaces": "bof_tpu/ops/matmul_pallas.py:65",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
