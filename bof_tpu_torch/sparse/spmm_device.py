"""Device-side sparse block compute and its host ELL prep, on torch.

The counterpart of `bof_tpu/sparse/spmm_device.py` (reference: mkl_scsrmm
in SimpleCsrmmRmTask::execute, csrmm_task.h:201-229; mkl_cspblas_scsrgemv
in csrgemv_task.h): a CSR row block becomes a padded ELL pair (ja, va) of
shape (rows_pad, rmax) on the host, and the block product is one launch
of kernel K2 (`spmm_cuda.spmm_ell`) or of the ELL SpMV
(`spmm_cuda.spmv_ell`).  Padding slots carry ja = 0, va = 0 and
contribute nothing.

The host prep is bof_tpu's, unchanged, so both packages form the same
bands from the same offsets.  Not ported yet: the bf16/int8 value
transfer modes (ROADMAP A6), which raise NotImplementedError.
"""
from __future__ import annotations

import numpy as np

from .spmm_cuda import spmm_ell, spmv_ell

_IMPLS = ("xla", "pallas", "auto")


def spmm_ell_block(b_panel, ja_ell, va_ell):
    """(rows, cb) = sum_s va_ell[row, s] * B[ja_ell[row, s]] (K2)."""
    return spmm_ell(b_panel, ja_ell, va_ell)


def spmm_ell_block_dispatch(b_panel, ja_ell, va_ell, impl: str = "auto"):
    """One ELL block product.  `impl` takes every value bof_tpu's
    FlashConfig.sparse_device_impl takes, so configurations round-trip;
    bof_tpu chooses between its XLA and Pallas bodies with it, and here
    every value runs K2, the one kernel that replaces both."""
    if impl not in _IMPLS:
        raise ValueError(f"sparse_device_impl {impl!r} not in {_IMPLS}")
    return spmm_ell(b_panel, ja_ell, va_ell)


def spmv_ell_block(x, ja_ell, va_ell):
    """y_blk[row] = sum_s va_ell[row, s] * x[ja_ell[row, s]] (csrgemv 'N')."""
    return spmv_ell(x, ja_ell, va_ell)


def expand_row_ids(ia_blk: np.ndarray) -> np.ndarray:
    """Per-nnz block-local row ids from an offsets slice ia[r0..r1]."""
    counts = np.diff(ia_blk)
    return np.repeat(np.arange(len(counts), dtype=np.int32), counts)


def _round_up_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def ell_dims(counts: np.ndarray, min_rows: int = 8):
    """(rows_pad, rmax) of the ELL block `to_ell` would build for these
    row counts: both rounded up to powers of two, rows_pad a multiple of
    `min_rows` (bof_tpu bucketed shapes to bound XLA compiles; the port
    keeps the rule so both packages build the same bands)."""
    rows = len(counts)
    rmax = max(1, _round_up_pow2(int(counts.max()) if rows else 1))
    rows_pad = max(8, _round_up_pow2(rows))
    if min_rows > 1:
        rows_pad = ((max(rows_pad, min_rows) + min_rows - 1)
                    // min_rows) * min_rows
    return rows_pad, rmax


def ell_idx_dtype(k_panel: int, narrow: bool = True):
    """Link dtype for ELL column indices: uint16 when every block-local
    index fits 16 bits (panel height <= 65536) and `narrow`, else int32.
    The kernels read either type directly."""
    return np.uint16 if narrow and 0 < k_panel <= 65536 else np.int32


def ell_val_dtype(storage_dtype, cfg):
    """Link dtype for ELL values: the storage dtype.  bof_tpu's bf16 and
    int8 value transfers (transfer_dtype 'bfloat16'/'int8' on fp32
    storage; its `ell_val_dtype`/`ell_val_quantize`) are ROADMAP A6 and
    raise; fp64 storage opts out of them, as in bof_tpu."""
    mode = cfg.transfer_dtype
    if np.dtype(storage_dtype) == np.float32 and mode != "float32":
        raise NotImplementedError(
            f"transfer_dtype={mode!r} for sparse ELL values is not ported "
            "yet (ROADMAP A6: transfer modes)")
    return np.dtype(storage_dtype)


def _ell_fill(starts: np.ndarray, counts: np.ndarray,
              ja_blk: np.ndarray, va_blk: np.ndarray,
              min_rows: int, rmax: int, rows_pad: int,
              idx_dtype=np.int32, val_dtype=None):
    rows = len(counts)
    d_rows_pad, d_rmax = ell_dims(counts, min_rows)
    rmax = rmax or d_rmax
    rows_pad = rows_pad or d_rows_pad
    if rows > rows_pad:
        raise ValueError(f"rows {rows} exceed rows_pad {rows_pad}")
    if len(ja_blk):
        # native single-pass gather (io/native.py ell_fill); bit-identical
        # output, numpy fallback otherwise
        from ..io.native import ell_fill
        nat = ell_fill(starts, counts, ja_blk, va_blk, rows_pad, rmax,
                       idx_dtype, val_dtype)
        if nat is not None:
            return nat
    slots = np.arange(rmax, dtype=np.int64)[None, :]
    idx = np.minimum(starts[:, None] + slots, max(len(ja_blk) - 1, 0))
    mask = slots < counts[:, None]
    ja_ell = np.zeros((rows_pad, rmax), idx_dtype)
    va_ell = np.zeros((rows_pad, rmax), val_dtype or va_blk.dtype)
    if len(ja_blk):
        ja_ell[:rows] = np.where(mask, ja_blk[idx], 0).astype(idx_dtype)
        va_ell[:rows] = np.where(mask, va_blk[idx], 0)
    return ja_ell, va_ell


def to_ell(ia_blk: np.ndarray, ja_blk: np.ndarray, va_blk: np.ndarray,
           min_rows: int = 8, rmax: int = 0, rows_pad: int = 0,
           idx_dtype=np.int32, val_dtype=None):
    """Convert a CSR row block to padded ELL (reference stores blocks CSR
    and calls MKL per block, csrmm_task.h).  Returns (ja_ell, va_ell) of
    shape (rows_pad, rmax); padding entries ja=0, va=0.  Explicit
    `rmax`/`rows_pad` override the derived values."""
    counts = np.diff(ia_blk).astype(np.int64)
    base = int(ia_blk[0])
    starts = ia_blk[:-1] - base
    return _ell_fill(starts, counts, ja_blk, va_blk, min_rows, rmax,
                     rows_pad, idx_dtype, val_dtype)


def to_ell_rows(ia_blk: np.ndarray, ja_blk: np.ndarray,
                va_blk: np.ndarray, rows_sel: np.ndarray,
                min_rows: int = 8, idx_dtype=np.int32, val_dtype=None,
                counts: np.ndarray = None):
    """ELL of an arbitrary row SELECTION of a block (rows_sel indexes
    into the block's rows), for count-sorted ELL banding: sorting rows by
    nnz before ranging makes each band's rmax tight to its own rows.  The
    caller scatters the output rows back through the same selection.
    `counts` (the block's np.diff(ia_blk), int64) may be passed to save
    the O(rows) diff per band."""
    if counts is None:
        counts = np.diff(ia_blk).astype(np.int64)
    base = int(ia_blk[0])
    starts = (ia_blk[:-1] - base)[rows_sel]
    return _ell_fill(starts, counts[rows_sel], ja_blk, va_blk, min_rows,
                     0, 0, idx_dtype, val_dtype)


def ell_row_ranges(counts: np.ndarray, entry_cap: int):
    """Split rows [0, len(counts)) into ranges whose padded ELL size
    (rows_pad * rmax_pad) stays under entry_cap — bounds device memory
    for skewed blocks (a mega-row gets a range of its own)."""
    n = len(counts)
    ranges = []
    s = 0
    cur_max = 1
    for r in range(n):
        c = max(1, int(counts[r]))
        new_max = max(cur_max, c)
        rows = r - s + 1
        if (rows > 1 and _round_up_pow2(rows) * _round_up_pow2(new_max)
                > entry_cap):
            ranges.append((s, r))
            s = r
            cur_max = c
        else:
            cur_max = new_max
    if s < n or not ranges:
        ranges.append((s, n))
    return ranges
