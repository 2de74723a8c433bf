"""Out-of-core CSR sparse matrix x dense vector, on torch.

The port of `bof_tpu/sparse/csrgemv.py` (reference: src/blas/csrgemv.cpp
:14-97 + include/tasks/csrgemv_task.h): the vectors live in DRAM (the
reference keeps x/y in memory, only A streams), row blocks are
nnz-budgeted, and each 'N' block is cut into count-sorted ELL bands, each
one launch of the ELL SpMV kernel (sparse/spmm_cuda.py:spmv_ell) against
x uploaded once, writing its rows of the block's device y in place; y
comes down once per block.  The bands' values cross the link as
FlashConfig.transfer_dtype says, as in bof_tpu: fp32, bf16, or int8 with
one fp32 scale an ELL row (fp32 storage only).  'T' is a scatter over columns, so it accumulates on the
HOST, as in bof_tpu and in the reference's mutex-guarded OpenMP
accumulation (csrgemv_task.h:169-176): one scipy CSC matvec per block
summed into a float64 y.  fp64 values take exact per-block scipy products
on the host (the device kernels are fp32).

Both paths run their stages in METRICS spans (csrgemv.disk_wait / prep /
compute / h2d / dispatch / d2h), inside the call's span `csrgemv`.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..context import get_context
from ..core.flash_array import FlashArray
from ..ops import device as dev
from ..utils import METRICS
from . import spmm_device as sdev
from .csr import CsrFlashMatrix, fill_row_blocks, stream_row_blocks

WAIT = "csrgemv.disk_wait"  # the span of each wait for A's next block


@METRICS.span("csrgemv")
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
            for r, e, ja_blk, va_blk in stream_row_blocks(
                    a, ia_np, blocks, ctx, wait_span=WAIT):
                with METRICS.span("csrgemv.prep"):
                    blk_ia = (ia_np[r:e + 1]
                              - int(ia_np[r])).astype(np.int64)
                    blk = sps.csr_matrix(
                        (va_blk, ja_blk.astype(np.int64), blk_ia),
                        shape=(e - r, k))
                with METRICS.span("csrgemv.compute"):
                    y[r:e] = blk @ x
            return y
        device = dev.resolve_device(cfg.device)
        ell_vdt = sdev.ell_val_dtype(vdt, cfg)
        v_quant = sdev.ell_val_quantize(vdt, cfg)
        y = np.empty(m, dtype=vdt)
        with METRICS.span("csrgemv.h2d", x.nbytes):
            x_dev = dev.to_device(x, device)
        ell_idt = sdev.ell_idx_dtype(k, cfg.ell_idx_narrow)
        for r, e, ja_blk, va_blk in stream_row_blocks(
                a, ia_np, blocks, ctx, wait_span=WAIT):
            with METRICS.span("csrgemv.prep"):
                blk_ia = ia_np[r:e + 1] - int(ia_np[r])
                counts = np.diff(blk_ia)
                order, ranges = sdev.band_plan(counts, entry_cap,
                                               cfg.ell_sort_rows)
            # the bands partition the block's rows and each writes its
            # own rows of y_blk in place: one download per block.  One
            # band at a time, so the host holds one band's ELL, not the
            # block's
            y_blk = torch.empty(e - r, dtype=torch.float32, device=device)
            for (s0, s1) in ranges:
                with METRICS.span("csrgemv.prep"):
                    band = sdev.build_band(blk_ia, ja_blk, va_blk,
                                           order[s0:s1], counts, ell_idt,
                                           ell_vdt, v_quant)
                with METRICS.span("csrgemv.h2d") as sp:
                    up = sdev.upload_band(band, device)
                    sp.nbytes = up.nbytes
                with METRICS.span("csrgemv.dispatch"):
                    sdev.spmv_ell_block(x_dev, up.ja, up.va, counts=up.counts,
                                        rows=up.rows, out=y_blk,
                                        va_scale=up.va_scale)
                del up
            with METRICS.span("csrgemv.d2h", y_blk.nbytes):
                y[r:e] = dev.from_device(y_blk)
        return y

    # trans: y[k] += A_blk^T x_blk — a scatter over columns, accumulated
    # on the host (the reference's mutexed OpenMP accumulate,
    # csrgemv_task.h:169-176): x_blk @ A_blk is ONE scipy csc_matvec pass
    # over the block's nnz (the csr.T view is O(1)); blocks sum into a
    # float64 y.  Within a block the accumulation is vdt-precision — the
    # reference's own semantics (MKL FPTYPE).
    import scipy.sparse as sps
    y = np.zeros(k, dtype=np.float64)
    for r, e, ja_blk, va_blk in stream_row_blocks(a, ia_np, blocks, ctx,
                                                  wait_span=WAIT):
        with METRICS.span("csrgemv.prep"):
            blk_ia = (ia_np[r:e + 1] - int(ia_np[r])).astype(np.int64)
            blk = sps.csr_matrix((va_blk, ja_blk, blk_ia), shape=(e - r, k))
            xb = np.ascontiguousarray(x[r:e], dtype=vdt)
        with METRICS.span("csrgemv.compute"):
            y += xb @ blk
    return y.astype(vdt)


def csrgemv_in_mem(a_sp, x: np.ndarray, trans: str = "N") -> np.ndarray:
    """Golden model (reference: drivers/in_mem_csrgemv.cpp)."""
    opa = a_sp.T if trans.upper() == "T" else a_sp
    return np.asarray(opa @ x, dtype=x.dtype)
