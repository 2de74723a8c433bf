"""Device-side sparse block compute and its host ELL prep, on torch.

The counterpart of `bof_tpu/sparse/spmm_device.py` (reference: mkl_scsrmm
in SimpleCsrmmRmTask::execute, csrmm_task.h:201-229; mkl_cspblas_scsrgemv
in csrgemv_task.h): a CSR row block becomes a padded ELL pair (ja, va) of
shape (rows_pad, rmax) on the host, and the block product is one launch
of kernel K2 (`spmm_cuda.spmm_ell`) or of the ELL SpMV
(`spmm_cuda.spmv_ell`).  Padding slots carry ja = 0, va = 0; the callers
pass each band's row counts, so the kernels never read them, and the
band's row selection, so each band writes its rows of the row-block
output in place.

Every sparse caller forms its bands here (`band_plan`, then `build_band`
a band or `ell_bands` a block) and uploads them with `upload_band`.

The host prep is bof_tpu's, unchanged, so both packages form the same
bands from the same offsets, and so are its transfer modes' values
(FlashConfig.transfer_dtype on fp32 storage): bf16 values (carried as
their np.uint16 bits, io/native.py) or int8 values with one fp32 scale an
ELL row, which the kernels promote in registers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..io.native import cast_bf16_numpy
from ..ops import device as dev
from .spmm_cuda import spmm_ell, spmv_ell

_IMPLS = ("xla", "pallas", "auto")


def spmm_ell_block(b_panel, ja_ell, va_ell, **where):
    """(rows, cb) = sum_s va_ell[row, s] * B[ja_ell[row, s]] (K2); `where`
    takes spmm_cuda's counts / rows / out / alpha / va_scale."""
    return spmm_ell(b_panel, ja_ell, va_ell, **where)


def spmm_ell_block_dispatch(b_panel, ja_ell, va_ell, impl: str = "auto",
                            **where):
    """One ELL block product.  `impl` takes every value bof_tpu's
    FlashConfig.sparse_device_impl takes, so configurations round-trip;
    bof_tpu chooses between its XLA and Pallas bodies with it, and here
    every value runs K2, the one kernel that replaces both."""
    if impl not in _IMPLS:
        raise ValueError(f"sparse_device_impl {impl!r} not in {_IMPLS}")
    return spmm_ell(b_panel, ja_ell, va_ell, **where)


def spmv_ell_block(x, ja_ell, va_ell, **where):
    """y_blk[row] = sum_s va_ell[row, s] * x[ja_ell[row, s]] (csrgemv 'N');
    `where` as for spmm_ell_block."""
    return spmv_ell(x, ja_ell, va_ell, **where)


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
    """Link dtype for ELL values (bof_tpu's `ell_val_dtype`).  With
    transfer_dtype='bfloat16' (the opt-in that halves gemm's A/B tiles)
    fp32 values are rounded to bf16 on the host, np.uint16 here (their
    bits), and promoted back in the kernels, halving the va half of every
    ELL upload.  fp64 storage opts out.  'int8' fills at float32 and
    quantizes after the ELL build (`ell_val_quantize` +
    `quantize_ell_i8`: the scales are per row, so they need the padded
    layout first)."""
    if (cfg.transfer_dtype == "bfloat16"
            and np.dtype(storage_dtype) == np.float32):
        return np.dtype(np.uint16)
    return np.dtype(storage_dtype)


def ell_val_quantize(storage_dtype, cfg) -> bool:
    """True when ELL values ship int8 (transfer_dtype='int8', fp32
    storage), with one scale a ROW (bof_tpu's `ell_val_quantize`): a
    block-wide max would crush small rows' values to zero on power-law
    rows, a row's own max keeps every value within 1/254 of it.  fp64
    opts out like bf16."""
    return (cfg.transfer_dtype == "int8"
            and np.dtype(storage_dtype) == np.float32)


def quantize_ell_i8(va_ell: np.ndarray):
    """(int8 values, f32 per-row scale) for a padded ELL value block,
    bof_tpu's `quantize_ell_i8` line for line.  Padding entries are exact
    zeros and stay exact; an all-zero row gets scale 1.0.  NaN-ignoring
    row amax and a +/-127 clamp, a NaN quantized to 0."""
    amax = np.fmax.reduce(np.abs(va_ell), axis=1, initial=0.0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    with np.errstate(invalid="ignore"):
        q = np.clip(np.rint(va_ell / scale[:, None]), -127, 127)
        q = np.nan_to_num(q, nan=0.0).astype(np.int8)
    return q, scale


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
    vd = np.dtype(val_dtype or va_blk.dtype)
    va_ell = np.zeros((rows_pad, rmax), vd)
    if len(ja_blk):
        ja_ell[:rows] = np.where(mask, ja_blk[idx], 0).astype(idx_dtype)
        vals = np.where(mask, va_blk[idx], 0)
        # bf16 bits from fp32 values: the engine's rounding
        va_ell[:rows] = (cast_bf16_numpy(vals) if vd == np.uint16
                         and va_blk.dtype == np.float32 else vals)
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


class EllBand(NamedTuple):
    """A CSR row block's band: the block rows it holds (int32; None for
    consecutive rows the caller places), their counts (int32), their
    (rows_pad, rmax) ELL pair, `va` an (int8, row scale) pair where
    quantized.  Rows past len(counts) are padding the kernels never read."""
    rows: np.ndarray
    counts: np.ndarray
    ja: np.ndarray
    va: object


class DeviceBand(NamedTuple):
    """`upload_band`'s tensors (`rows` None where it stayed on the host,
    `va_scale` None unless int8) and the bytes that went up."""
    rows: object
    counts: object
    ja: object
    va: object
    va_scale: object
    nbytes: int


def band_plan(counts: np.ndarray, entry_cap: int, sort_rows: bool = True):
    """(order, ranges): a row block's rows ordered by count (stable; the
    identity without `sort_rows`) and cut into ranges of that order whose
    padded ELL stays under `entry_cap` entries, so each band's rmax is
    tight to its own rows.  Band (s0, s1) holds rows order[s0:s1].

    Unsorted rows take `ell_row_ranges`' scan.  Sorted rows give the same
    ranges in numpy, a band at a time, for blocks of hundreds of
    thousands of rows (the stable sort is a radix sort where the counts
    fit 16 bits): on count-sorted rows the scan closes a band at the
    first row r past its start s with pow2(r - s + 1) * pow2(count_r) >
    entry_cap, and both factors only grow with r; so within each run of
    rows sharing pow2(count) = P, the first row that closes the band is
    s + M(P), M(P) the largest power of two with M(P) * P <= entry_cap
    (0 where P alone exceeds it), or the run's first row if that lies
    past s + M(P)."""
    counts = np.asarray(counts)
    n = len(counts)
    if not sort_rows:
        return np.arange(n), ell_row_ranges(counts, entry_cap)
    if n == 0:
        return np.arange(0), [(0, 0)]
    keys = counts
    if counts.min() >= 0 and counts.max() < 1 << 16:
        keys = counts.astype(np.uint16)
    order = np.argsort(keys, kind="stable")
    c = np.maximum(counts[order].astype(np.int64), 1)
    powers = np.int64(1) << np.arange(63, dtype=np.int64)
    level = powers[np.searchsorted(powers, c)]       # pow2(count)
    starts = np.concatenate(([0], np.flatnonzero(np.diff(level)) + 1))
    ends = np.append(starts[1:], n)
    runs = []
    for a, b, p in zip(starts.tolist(), ends.tolist(),
                       level[starts].tolist()):
        f = int(entry_cap) // p
        runs.append((a, b, 1 << (f.bit_length() - 1) if f else 0))
    ranges, s, j = [], 0, 0
    while s < n:
        e = n
        while runs[j][1] <= s:
            j += 1
        for a, b, most in runs[j:]:
            first = max(a, s + 1, s + most)
            if first < b:
                e = first
                break
        ranges.append((s, e))
        s = e
    return order, ranges


def build_band(blk_ia, ja_blk, va_blk, rows_sel, counts,
               idx_dtype=np.int32, val_dtype=None,
               quantize: bool = False) -> EllBand:
    """The band of rows `rows_sel` of a row block (`blk_ia` its offsets,
    `counts` their np.diff) at the link's dtypes."""
    ja_ell, va_ell = to_ell_rows(blk_ia, ja_blk, va_blk, rows_sel,
                                 idx_dtype=idx_dtype, val_dtype=val_dtype,
                                 counts=counts)
    if quantize:
        va_ell = quantize_ell_i8(va_ell)
    return EllBand(rows_sel.astype(np.int32),
                   counts[rows_sel].astype(np.int32), ja_ell, va_ell)


def ell_bands(blk_ia, ja_blk, va_blk, entry_cap: int, cfg, idx_dtype,
              val_dtype, quantize: bool = False) -> list:
    """Every band of one row block (`blk_ia` its offsets from 0), which
    together partition its rows."""
    counts = np.diff(blk_ia)
    order, ranges = band_plan(counts, entry_cap, cfg.ell_sort_rows)
    return [build_band(blk_ia, ja_blk, va_blk, order[s0:s1], counts,
                       idx_dtype, val_dtype, quantize)
            for s0, s1 in ranges]


def upload_band(band: EllBand, device, lo: int = 0, hi: int = None,
                with_rows: bool = True) -> DeviceBand:
    """Rows [lo, hi) of `band` (all of them, padding too, by default) to
    the device: the rows where `with_rows` (for kernels that write each
    row of the block's output in place), counts, ja and the values (bf16
    where they are its np.uint16 bits).  Callers drop the result once its
    launch is queued, so one band's buffers are on the device at a time."""
    nbytes = 0

    def up(host, bf16=False):
        nonlocal nbytes
        host = host[lo:hi]
        nbytes += host.nbytes
        return (dev.to_device_bf16 if bf16 else dev.to_device)(host, device)

    rows = up(band.rows) if with_rows else None
    counts, ja = up(band.counts), up(band.ja)
    if isinstance(band.va, tuple):  # int8 values and their row scales
        va, scale = up(band.va[0]), up(band.va[1])
    else:
        va, scale = up(band.va, band.va.dtype == np.uint16), None
    return DeviceBand(rows, counts, ja, va, scale, nbytes)
