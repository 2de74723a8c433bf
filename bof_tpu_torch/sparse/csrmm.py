"""Out-of-core CSR sparse x dense matrix multiply, on torch.

The port of `bof_tpu/sparse/csrmm.py` (reference: src/blas/csrmm.cpp):
the offsets array is read synchronously, row blocks are formed by nnz
budget, B is cut into column panels, and 'T' either streams A once on the
host or transposes A via csrcsc into scratch and recurses as 'N'
(csrmm.cpp:364-420).

On the device: the B column panel (k x cb) is uploaded once per column
block and reused by every row block; sparse row blocks stream through the
pin cache with prefetch lookahead, are cut into count-sorted ELL bands on
the host and multiplied by kernel K2 (sparse/spmm_cuda.py).  When even
the narrowest B panel exceeds the device budget, the K dimension splits
into ranges accumulated into C with a barrier between them.  C row
panels are written back asynchronously by a writer thread.  The planner's
constants are bof_tpu's, so both packages form the same blocks and bands.

Streams: the uploader (B panel, ELL uploads, K2 launches) and the writer
(downloads) use their thread's current stream, the device's default
stream, so every launch follows its uploads and every download follows
its launch, as in ops/gemm.py.  Transfers are synchronous pageable
copies.

Not ported yet, and refused with NotImplementedError: the bf16/int8 ELL
value transfers and the bf16 C download (ROADMAP A6).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..context import get_context
from ..core.flash_array import FlashArray
from ..core.pipeline import PrefetchSeq
from ..ops import device as dev
from ..utils import LOG, METRICS, Timer
from . import spmm_device as sdev
from .csr import CsrFlashMatrix, fill_row_blocks


def _col_block_width(n: int, k: int, cfg) -> int:
    cb = min(n, cfg.csrmm_cblk_size)
    # B panel (k x cb) + transposed copy must fit comfortably in HBM
    max_cb = max(128, int(cfg.hbm_budget // 3 // max(k * 4, 1)))
    return max(1, min(cb, max_cb))


def _resolve_sparse_compute(cfg, m: int, k: int, n: int, nnz: int) -> str:
    """Compute placement for the block products.  'auto' estimates both
    paths: the device path ships ELL-padded sparse blocks + the B panel up
    and C down over the measured host<->device link; the host path runs
    scipy block products in place (the reference's own execution model —
    MKL on the host, csrmm_task.h).  A real link (>= 1 GB/s) always
    picks the device; on a thin link small problems stay on the host."""
    mode = getattr(cfg, "sparse_compute", "device")
    if mode != "auto":
        return mode
    link = dev.link_gbps_estimate(dev.resolve_device(cfg.device))
    if link >= 1.0:
        return "device"
    dev_bytes = nnz * 16.0 + k * n * 4.0 + m * n * 4.0  # ELL + B up, C down
    t_dev = dev_bytes / (link * 1e9)
    t_host = 2.0 * nnz * n / 2.0e9  # scipy csr@dense ~2 GFLOP/s effective
    return "host" if t_host < t_dev else "device"


def csrmm(a: CsrFlashMatrix, b: FlashArray, c: FlashArray,
          alpha: float = 1.0, beta: float = 0.0, transa: str = "N",
          ctx=None) -> None:
    """C = alpha * op(A) B + beta * C with A sparse flash-resident CSR.

    op(A)=A: A (m,k), B (k,n), C (m,n).  op(A)=A^T: C (k_A, n) — A is
    transposed into scratch via csrcsc first (reference: csrmm.cpp:364-420).
    """
    ctx = ctx or b.ctx or get_context()
    if transa.upper() == "T":
        # host placement with a (k, n) output that fits the host budget
        # (float64 accumulator = 2x, plus one B block): stream A's row
        # blocks ONCE and accumulate C += A_rb^T B_rb in DRAM.  Device
        # placement or a larger C: materialize A^T via csrcsc and recurse
        # as 'N' (csrmm.cpp:364-420), whose block products run on the card.
        n_cols = b.shape[1]
        mode = _resolve_sparse_compute(ctx.config, a.shape[1], a.shape[0],
                                       n_cols, a.nnz)
        if not dev.dtype_native_on_device(a.vals.dtype):
            mode = "host"  # fp64 vals: exact host path (guard below)
        if (mode == "host"
                and 3 * c.nbytes + b.nbytes <= ctx.config.program_budget):
            _csrmm_trans_streaming(a, b, c, alpha, beta, ctx)
            return
        from .csrcsc import csrcsc_scratch
        at = csrcsc_scratch(a, ctx=ctx)
        try:
            csrmm(at, b, c, alpha=alpha, beta=beta, transa="N", ctx=ctx)
        finally:
            from ..core.flash_array import flash_free
            for arr in (at.ia, at.ja, at.vals):
                flash_free(arr)
        return

    cfg = ctx.config
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"B rows {b.shape[0]} != A cols {k}")
    n = b.shape[1]
    if c.shape != (m, n):
        raise ValueError(f"C shape {c.shape} != ({m}, {n})")
    from ..core.flash_array import check_output_distinct
    check_output_distinct(c, b=b, ia=a.ia, ja=a.ja, vals=a.vals)
    if not (b.dtype == c.dtype == a.vals.dtype):
        # fail up front like gemm does — a mismatch would otherwise
        # surface as a confusing buffer-size error inside the writer
        raise ValueError(
            f"mixed dtypes not supported: vals {a.vals.dtype}, "
            f"B {b.dtype}, C {c.dtype}")

    timer = Timer()
    ia_np = a.read_ia()
    blocks = fill_row_blocks(ia_np, cfg.max_nnzs)
    cb = _col_block_width(n, k, cfg)
    # device ELL budget: rows_pad * rmax * cb * 4 B (bof_tpu's gather
    # intermediate; kept so both packages form the same bands)
    entry_cap = max(1 << 14, int(cfg.hbm_budget // 6 // (cb * 4)))
    cache = ctx.pin_cache()
    idt = a.ja.dtype
    vdt = a.vals.dtype

    # K splitting: when even the narrowest B panel (k x cb) exceeds the
    # HBM budget, partition the K dimension; each range streams a B
    # sub-panel and contributes C += alpha * A[:, k0:k1] B[k0:k1, :]
    # (first range applies the caller's beta, later ranges beta=1).
    if k * cb * 4 <= cfg.hbm_budget // 3:
        k_ranges = [(0, k)]
    else:
        k_r = max(4096, int(cfg.hbm_budget // 3 // (cb * 4)))
        k_ranges = [(s, min(s + k_r, k)) for s in range(0, k, k_r)]
    k_r_pad = max(k1 - k0 for k0, k1 in k_ranges)

    # sparse-block access sequence (reused per column block via the cache)
    seq_accesses = []
    for r, e in blocks:
        i0, i1 = int(ia_np[r]), int(ia_np[e])
        ja_off, ja_sin = a.ja.block_access(i0, i1 - i0)
        va_off, va_sin = a.vals.block_access(i0, i1 - i0)
        seq_accesses.append(((a.ja.store, ja_off, ja_sin),
                             (a.vals.store, va_off, va_sin)))

    host_compute = _resolve_sparse_compute(cfg, m, k, n, a.nnz) == "host"
    if not host_compute and not dev.dtype_native_on_device(vdt):
        # fp64 vals: the device kernels are fp32, so the scipy host path
        # is the exact execution model (the reference's own MKL-on-host,
        # csrmm_task.h:201-229)
        LOG.info("csrmm: %s not representable on the device kernels; "
                 "using host block products", vdt)
        host_compute = True
    device = None
    if not host_compute:
        device = dev.resolve_device(cfg.device)
        sdev.ell_val_dtype(vdt, cfg)  # the A6 transfer modes raise here
        if cfg.c_transfer_dtype != "float32":
            raise NotImplementedError(
                f"c_transfer_dtype={cfg.c_transfer_dtype!r} is not ported "
                "yet (ROADMAP A6: transfer modes)")
    from ..core.pipeline import TicketWindow
    for ri, (k0, k1) in enumerate(k_ranges):
        beta_eff = beta if ri == 0 else 1.0
        write_tickets = TicketWindow(depth=8)
        _csrmm_range(a, b, c, alpha, beta_eff, k0, k1, k_r_pad, blocks,
                     ia_np, seq_accesses, cb, entry_cap, cache, cfg,
                     device, idt, vdt, write_tickets)
        write_tickets.wait_all()  # range barrier: later ranges RMW C
        METRICS.add("csrmm.write_wait_s", write_tickets.wait_s)
    c.store.flush()
    METRICS.add("csrmm.ms", timer.elapsed_ms())
    LOG.debug("csrmm %dx%dx%d nnz=%d done in %.1f ms (%d k-ranges)",
              m, k, n, a.nnz, timer.elapsed_ms(), len(k_ranges))


def _csrmm_trans_streaming(a, b, c, alpha, beta, ctx):
    """C = alpha * A^T B + beta * C in one streaming pass over A's row
    blocks, accumulating the DRAM-resident (k, n) float64 output per
    block: C += A_rb^T B_rb (host products).  Preconditions checked by the
    dispatcher: host placement resolved, and 2x|C| (the accumulator) +
    |C| chunking headroom + one B block fit the host budget."""
    import scipy.sparse as sps

    from .csr import stream_row_blocks

    cfg = ctx.config
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != m:
        raise ValueError(f"B rows {b.shape[0]} != op(A) cols {m}")
    if c.shape != (k, n):
        raise ValueError(f"C shape {c.shape} != ({k}, {n})")
    if not (b.dtype == c.dtype == a.vals.dtype):
        raise ValueError(
            f"mixed dtypes not supported: vals {a.vals.dtype}, "
            f"B {b.dtype}, C {c.dtype}")

    timer = Timer()
    vdt = a.vals.dtype
    ia_np = a.read_ia()
    blocks = fill_row_blocks(ia_np, cfg.max_nnzs)
    acc = np.zeros((k, n), np.float64)
    for r, e, ja_blk, va_blk in stream_row_blocks(a, ia_np, blocks, ctx):
        blk = sps.csr_matrix(
            (va_blk, ja_blk.astype(np.int64),
             (ia_np[r:e + 1] - int(ia_np[r])).astype(np.int64)),
            shape=(e - r, k))
        acc += blk.T @ b.read_block(r, e - r, 0, n)
    acc *= alpha
    chunk = max(1, min(k, (64 << 20) // max(8 * n, 1)))
    for r0 in range(0, k, chunk):
        rn = min(chunk, k - r0)
        if beta != 0.0:
            acc[r0:r0 + rn] += beta * c.read_block(r0, rn, 0, n)
        c.write_block(r0, acc[r0:r0 + rn].astype(vdt), 0)
    c.store.flush()
    METRICS.add("csrmm.ms", timer.elapsed_ms())
    LOG.debug("csrmm 'T' streaming %dx%dx%d nnz=%d done in %.1f ms",
              m, k, n, a.nnz, timer.elapsed_ms())


def _upload_b_panel(b_host, b_order, k_sub, bc, k_r_pad, cb, device):
    """The (k_r_pad, cb) device panel of one B column block: a column-major
    block is transposed on the device, and both dims are zero-padded."""
    b_dev = dev.to_device(b_host, device)
    if b_order == "C":
        b_dev = b_dev.T  # (k_sub, bc) view; copied contiguous below
    if bc < cb or k_sub < k_r_pad:
        panel = torch.zeros((k_r_pad, cb), dtype=b_dev.dtype, device=device)
        panel[:k_sub, :bc] = b_dev
        return panel
    return b_dev.contiguous()


def _csrmm_range(a, b, c, alpha, beta, k0, k1, k_r_pad, blocks, ia_np,
                 seq_accesses, cb, entry_cap, cache, cfg, device,
                 idt, vdt, write_tickets):
    """One K range of csrmm 'N'; `device` is None for host compute."""
    host_compute = device is None
    n = b.shape[1]
    k_sub = k1 - k0
    full_k = (k0 == 0 and k1 == a.shape[1])
    # tile-major dense operands (core/tiled_array.py): csrmm's row blocks
    # are nnz-adaptive, so tile-aligned storage access can't apply — the
    # general-window paths decompose into contiguous tile visits instead
    b_tiled = getattr(b, "tile", None) is not None
    c_tiled = getattr(c, "tile", None) is not None
    sync_mode = cfg.telemetry_sync
    for c0 in range(0, n, cb):
        bc = min(cb, n - c0)
        # B column sub-panel, shaped (k_sub, cb); pad both dims
        if b_tiled:
            b_host = b.read_block(k0, k_sub, c0, bc)  # logical row-major
            b_order = "R"
        else:
            b_host = b.read_block_storage(k0, k_sub, c0, bc)
            b_order = b.order
        if host_compute:
            b_panel_np = (b_host if b_order == "R"
                          else np.ascontiguousarray(b_host.T))
            b_panel = None
        else:
            t_up = time.perf_counter()
            b_panel = _upload_b_panel(b_host, b_order, k_sub, bc, k_r_pad,
                                      cb, device)
            if sync_mode:
                dev.sync(b_panel)
            METRICS.add("csrmm.h2d_s", time.perf_counter() - t_up)
            del b_host

        flat = [acc for pair in seq_accesses for acc in pair]
        pf = PrefetchSeq(cache, flat, depth=2 * cfg.pipeline_depth)

        # 4-stage pipeline per column panel (mirrors ops/gemm.py):
        # prepper: disk tiles -> ELL prep (CPU)
        # uploader: H2D + K2 launches (device path only — prep of block
        #   b+1 overlaps the uploads of block b)
        # writer: D2H of results -> alpha/beta -> async disk write
        out_q: queue.Queue = queue.Queue(maxsize=max(2, cfg.pipeline_depth))
        prep_q: queue.Queue = queue.Queue(maxsize=max(2, cfg.pipeline_depth))
        errors: list = []

        from ..core.pipeline import queue_put, queue_put_sentinel

        def _put(q, item) -> bool:
            return queue_put(q, item, errors)

        def _put_sentinel(q):
            queue_put_sentinel(q, errors)

        # host path: prepper feeds the writer directly (the scipy block
        # product IS the compute); device path: prepper feeds the uploader
        prep_dest = out_q if host_compute else prep_q

        def prepper():
            try:
                for bi, (r, e) in enumerate(blocks):
                    i0, i1 = int(ia_np[r]), int(ia_np[e])
                    nnz_b, rows_b = i1 - i0, e - r
                    t0 = time.perf_counter()
                    ja_blk = pf.get(2 * bi).view(idt)
                    va_blk = pf.get(2 * bi + 1).view(vdt)
                    t1 = time.perf_counter()
                    METRICS.add("csrmm.disk_wait_s", t1 - t0)
                    if cfg.debug_checks:
                        from .csr import verify_csr_block
                        verify_csr_block(ia_np[r:e + 1], ja_blk,
                                         a.shape[1], nnz_b)
                    if full_k:
                        blk_ia = ia_np[r:e + 1] - i0
                        blk_ja, blk_va = ja_blk, va_blk
                    else:
                        # K-split: keep only entries in [k0, k1), shifted
                        sel = (ja_blk >= k0) & (ja_blk < k1)
                        row_ids = sdev.expand_row_ids(ia_np[r:e + 1])
                        cnt = np.bincount(row_ids[sel], minlength=rows_b)
                        blk_ia = np.zeros(rows_b + 1, np.int64)
                        np.cumsum(cnt, out=blk_ia[1:])
                        blk_ja = ja_blk[sel] - k0
                        blk_va = va_blk[sel]
                    if host_compute:
                        import scipy.sparse as sps
                        blk_sp = sps.csr_matrix(
                            (blk_va, blk_ja.astype(np.int64),
                             blk_ia.astype(np.int64)),
                            shape=(rows_b, k_sub))
                        # reference-style CPU block product (MKL's role)
                        payload = (r, rows_b, [(None, blk_sp @ b_panel_np)])
                    else:
                        counts = np.diff(blk_ia)
                        bands = []
                        # count-sorted ELL banding: range over rows SORTED
                        # by nnz so each band's rmax is tight to its own
                        # rows, not the block max; output rows scatter
                        # back through the same selection on the host
                        order = (np.argsort(counts, kind="stable")
                                 if cfg.ell_sort_rows
                                 else np.arange(rows_b))
                        ell_idt = sdev.ell_idx_dtype(k_sub,
                                                     cfg.ell_idx_narrow)
                        for (s0, s1) in sdev.ell_row_ranges(
                                counts[order], entry_cap):
                            rows_sel = order[s0:s1]
                            ja_ell, va_ell = sdev.to_ell_rows(
                                blk_ia, blk_ja, blk_va, rows_sel,
                                idx_dtype=ell_idt, counts=counts)
                            bands.append((rows_sel, ja_ell, va_ell))
                        payload = (r, rows_b, bands)
                    pf.done(2 * bi)
                    pf.done(2 * bi + 1)
                    METRICS.add("csrmm.prep_s", time.perf_counter() - t1)
                    if not _put(prep_dest, payload):
                        return
                _put_sentinel(prep_dest)
            except BaseException as e:  # pragma: no cover
                errors.append(e)
                try:
                    prep_dest.put_nowait(None)
                except queue.Full:
                    pass

        def uploader():
            try:
                impl = cfg.sparse_device_impl
                while True:
                    try:  # timeout-get: a dead prepper can't hang us
                        item = prep_q.get(timeout=1.0)
                    except queue.Empty:
                        if errors:
                            break
                        continue
                    if item is None:
                        break
                    r, rows_b, bands = item
                    t1 = time.perf_counter()
                    outs = []
                    for rows_sel, ja_ell, va_ell in bands:
                        th = time.perf_counter()
                        ja_d = dev.to_device(ja_ell, device)
                        va_d = dev.to_device(va_ell, device)
                        if sync_mode:
                            # in-window sync: the rate sample is a
                            # transfer rate, not an enqueue time
                            dev.sync(va_d)
                            th2 = time.perf_counter()
                            METRICS.observe(
                                "csrmm.h2d_tile_gbps",
                                (ja_ell.nbytes + va_ell.nbytes)
                                / max(th2 - th, 1e-9) / 1e9)
                        METRICS.add("csrmm.h2d_s", time.perf_counter() - th)
                        out = sdev.spmm_ell_block_dispatch(
                            b_panel, ja_d, va_d, impl=impl)
                        outs.append((rows_sel, out))
                    METRICS.add("csrmm.dispatch_s",
                                time.perf_counter() - t1)
                    if not _put(out_q, (r, rows_b, outs)):
                        return
                _put_sentinel(out_q)
            except BaseException as e:  # pragma: no cover
                errors.append(e)
                try:
                    out_q.put_nowait(None)
                except queue.Full:
                    pass

        def writer():
            try:
                while True:
                    try:  # timeout-get: a dead producer can't hang us
                        item = out_q.get(timeout=1.0)
                    except queue.Empty:
                        if errors:
                            break
                        continue
                    if item is None:
                        break
                    r, rows_b, outs = item
                    c_np = np.empty((rows_b, bc), vdt)
                    for sel, out in outs:
                        if isinstance(out, np.ndarray):
                            # host block product: already in DRAM
                            c_np[:] = out[:, :bc]
                            continue
                        t0 = time.perf_counter()
                        if sync_mode:
                            dev.sync(out)  # wait for the block's K2
                            ta = time.perf_counter()
                            full = dev.from_device(out)
                            tb = time.perf_counter()
                            METRICS.add("csrmm.accum_wait_s", ta - t0)
                            METRICS.add("csrmm.d2h_s", tb - ta)
                            METRICS.observe(
                                "csrmm.d2h_tile_gbps",
                                full.nbytes / max(tb - ta, 1e-9) / 1e9)
                        else:
                            full = dev.from_device(out)
                            METRICS.add("csrmm.d2h_s",
                                        time.perf_counter() - t0)
                        METRICS.add("csrmm.d2h_bytes", full.nbytes)
                        t0 = time.perf_counter()
                        if sel is None:
                            c_np[:] = full[:rows_b, :bc]
                        else:
                            c_np[sel] = full[:len(sel), :bc]
                        METRICS.add("csrmm.assemble_s",
                                    time.perf_counter() - t0)
                    del outs  # release the block's device outputs
                    t0 = time.perf_counter()
                    c_np *= alpha
                    METRICS.add("csrmm.assemble_s", time.perf_counter() - t0)
                    if beta != 0.0:
                        t0 = time.perf_counter()
                        c_np += beta * c.read_block(r, rows_b, c0, bc)
                        METRICS.add("csrmm.c_read_s",
                                    time.perf_counter() - t0)
                    if c_tiled:
                        # general-window RMW through the tile grid (sync;
                        # no ticket — the k-range barrier is implicit)
                        c.write_block(
                            r, np.ascontiguousarray(c_np, dtype=vdt), c0)
                        continue
                    c_np = np.ascontiguousarray(c_np, dtype=vdt)
                    if c.order != "R":
                        c_np = np.ascontiguousarray(c_np.T)
                    write_tickets.push(c.write_block_storage_async(
                        r, c0, rows_b, bc, c_np))
            except BaseException as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=prepper, daemon=True),
                   threading.Thread(target=writer, daemon=True)]
        if not host_compute:
            threads.insert(1, threading.Thread(target=uploader, daemon=True))
        for t in threads:
            t.start()
        # unbounded joins on the healthy path (writers legitimately take
        # long on slow disks); bounded only once an error is recorded
        for t in threads:
            while t.is_alive():
                t.join(timeout=1.0)
                if errors:
                    t.join(timeout=30)
                    break
        pf.close()
        if errors:
            raise errors[0]


def csrmm_in_mem(a_sp, b_np: np.ndarray, c_np: Optional[np.ndarray] = None,
                 alpha: float = 1.0, beta: float = 0.0,
                 transa: str = "N") -> np.ndarray:
    """In-memory golden model (reference: drivers/in_mem_csrmm.cpp)."""
    opa = a_sp.T if transa.upper() == "T" else a_sp
    out = alpha * (opa @ b_np)
    if beta != 0.0 and c_np is not None:
        out = out + beta * c_np
    return np.asarray(out, dtype=b_np.dtype)
