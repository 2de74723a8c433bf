"""Out-of-core CSR sparse matrix x dense vector, on torch.

The port of `bof_tpu/sparse/csrgemv.py` (reference: src/blas/csrgemv.cpp
:14-97 + include/tasks/csrgemv_task.h): the vectors live in DRAM (the
reference keeps x/y in memory, only A streams), row blocks are
nnz-budgeted, and each 'N' block is cut into count-sorted ELL bands, each
one launch of the ELL SpMV kernel (sparse/spmm_cuda.py:spmv_ell) against
x uploaded once.  'T' is a scatter over columns, so it accumulates on the
HOST, as in bof_tpu and in the reference's mutex-guarded OpenMP
accumulation (csrgemv_task.h:169-176): one scipy CSC matvec per block
summed into a float64 y.  fp64 values take exact per-block scipy products
on the host (the device kernels are fp32).

Both paths meter the stage partition into METRICS (csrgemv.disk_wait_s /
prep_s / compute_s / h2d_s / dispatch_s / d2h_s).
"""
from __future__ import annotations

import time
from typing import Union

import numpy as np

from ..context import get_context
from ..core.flash_array import FlashArray
from ..ops import device as dev
from ..utils import METRICS
from . import spmm_device as sdev
from .csr import CsrFlashMatrix, fill_row_blocks, stream_row_blocks


def _metered_blocks(a, ia_np, blocks, ctx):
    """stream_row_blocks with the time blocked on disk/pin-cache arrival
    recorded as csrgemv.disk_wait_s."""
    it = stream_row_blocks(a, ia_np, blocks, ctx)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            METRICS.add("csrgemv.disk_wait_s", time.perf_counter() - t0)
            yield item
    finally:
        it.close()


def csrgemv(a: CsrFlashMatrix, x: Union[np.ndarray, FlashArray],
            trans: str = "N", ctx=None) -> np.ndarray:
    """y = op(A) x.  x and the returned y are host vectors (the reference
    keeps csrgemv vectors in DRAM)."""
    ctx = ctx or a.ctx or get_context()
    cfg = ctx.config
    m, k = a.shape
    if isinstance(x, FlashArray):
        x = x.read_all()
    x = np.asarray(x, dtype=a.vals.dtype)
    t = trans.upper() == "T"
    if x.shape != ((m,) if t else (k,)):
        raise ValueError(f"x shape {x.shape} wrong for trans={trans}")

    ia_np = a.read_ia()
    blocks = fill_row_blocks(ia_np, cfg.max_nnzs)
    vdt = a.vals.dtype
    entry_cap = 1 << 22  # rows_pad * rmax ELL budget for the vector case

    if not t:
        if not dev.dtype_native_on_device(vdt):
            # fp64 vals: per-block scipy products on the host (exact; the
            # 'T' path below is host-side already)
            import scipy.sparse as sps
            y = np.empty(m, dtype=vdt)
            for r, e, ja_blk, va_blk in _metered_blocks(
                    a, ia_np, blocks, ctx):
                t0 = time.perf_counter()
                blk_ia = (ia_np[r:e + 1] - int(ia_np[r])).astype(np.int64)
                blk = sps.csr_matrix(
                    (va_blk, ja_blk.astype(np.int64), blk_ia),
                    shape=(e - r, k))
                METRICS.add("csrgemv.prep_s", time.perf_counter() - t0)
                t0 = time.perf_counter()
                y[r:e] = blk @ x
                METRICS.add("csrgemv.compute_s", time.perf_counter() - t0)
            return y
        device = dev.resolve_device(cfg.device)
        sdev.ell_val_dtype(vdt, cfg)  # the A6 transfer modes raise here
        y = np.empty(m, dtype=vdt)
        t0 = time.perf_counter()
        x_dev = dev.to_device(x, device)
        METRICS.add("csrgemv.h2d_s", time.perf_counter() - t0)
        ell_idt = sdev.ell_idx_dtype(k, cfg.ell_idx_narrow)
        for r, e, ja_blk, va_blk in _metered_blocks(a, ia_np, blocks, ctx):
            t0 = time.perf_counter()
            blk_ia = ia_np[r:e + 1] - int(ia_np[r])
            counts = np.diff(blk_ia)
            # count-sorted ELL banding (see sparse/csrmm.py): tight rmax
            # per band on skewed rows
            order = (np.argsort(counts, kind="stable") if cfg.ell_sort_rows
                     else np.arange(e - r))
            METRICS.add("csrgemv.prep_s", time.perf_counter() - t0)
            for (s0, s1) in sdev.ell_row_ranges(counts[order], entry_cap):
                t0 = time.perf_counter()
                rows_sel = order[s0:s1]
                ja_ell, va_ell = sdev.to_ell_rows(blk_ia, ja_blk, va_blk,
                                                  rows_sel,
                                                  idx_dtype=ell_idt,
                                                  counts=counts)
                t1 = time.perf_counter()
                METRICS.add("csrgemv.prep_s", t1 - t0)
                ja_d = dev.to_device(ja_ell, device)
                va_d = dev.to_device(va_ell, device)
                t2 = time.perf_counter()
                METRICS.add("csrgemv.h2d_s", t2 - t1)
                out = sdev.spmv_ell_block(x_dev, ja_d, va_d)
                t3 = time.perf_counter()
                METRICS.add("csrgemv.dispatch_s", t3 - t2)
                y[r + rows_sel] = dev.from_device(out)[:len(rows_sel)]
                METRICS.add("csrgemv.d2h_s", time.perf_counter() - t3)
        return y

    # trans: y[k] += A_blk^T x_blk — a scatter over columns, accumulated
    # on the host (the reference's mutexed OpenMP accumulate,
    # csrgemv_task.h:169-176): x_blk @ A_blk is ONE scipy csc_matvec pass
    # over the block's nnz (the csr.T view is O(1)); blocks sum into a
    # float64 y.  Within a block the accumulation is vdt-precision — the
    # reference's own semantics (MKL FPTYPE).
    import scipy.sparse as sps
    y = np.zeros(k, dtype=np.float64)
    for r, e, ja_blk, va_blk in _metered_blocks(a, ia_np, blocks, ctx):
        t0 = time.perf_counter()
        blk_ia = (ia_np[r:e + 1] - int(ia_np[r])).astype(np.int64)
        blk = sps.csr_matrix((va_blk, ja_blk, blk_ia), shape=(e - r, k))
        xb = np.ascontiguousarray(x[r:e], dtype=vdt)
        METRICS.add("csrgemv.prep_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        y += xb @ blk
        METRICS.add("csrgemv.compute_s", time.perf_counter() - t0)
    return y.astype(vdt)


def csrgemv_in_mem(a_sp, x: np.ndarray, trans: str = "N") -> np.ndarray:
    """Golden model (reference: drivers/in_mem_csrgemv.cpp)."""
    opa = a_sp.T if trans.upper() == "T" else a_sp
    return np.asarray(opa @ x, dtype=x.dtype)
