"""Out-of-core CSR <-> CSC transpose (A^T materialization).

Re-design of the reference's flash::csrcsc (reference:
src/blas/csrcsc.cpp:32-159 + include/tasks/csrcsc_task.h), keeping its
two-phase barrier structure:

  phase 1 (BlockCsrCscTask, csrcsc.cpp:44-87): each nnz-budgeted row block
    is transposed independently — entries stably sorted by column — into
    per-block scratch flash files (row indices + values), with per-block
    column counts reported to the host;
  host: merge per-block column counts into the global transposed offsets
    array by prefix sum (csrcsc.cpp:89-99), written synchronously;
  phase 2 (BlockMergeTask, csrcsc.cpp:101-147): each column block of the
    output gathers every row block's column slice and concatenates them
    row-ascending (stable block order == ascending source rows) into the
    final ja_tr/vals_tr ranges.

The per-block transpose is a stable argsort by column (the reference calls
mkl_csrcsc per block); the phase-2 ragged interleave is fully vectorized
index arithmetic.  Both phases run as scheduler task DAGs separated by a
barrier + cache flush, exactly like the reference's two rounds
(csrcsc.cpp:79-80, 141-142).
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from ..context import get_context
from ..core.flash_array import FlashArray, flash_empty
from ..core.task import FnTask
from ..utils import fatal
from .csr import CsrFlashMatrix, fill_row_blocks


def csrcsc(a: CsrFlashMatrix, out: CsrFlashMatrix, ctx=None) -> None:
    """out = A^T as CSR (equivalently, the CSC form of A)."""
    ctx = ctx or a.ctx or get_context()
    cfg = ctx.config
    m, k = a.shape
    if out.shape != (k, m):
        raise ValueError(f"output shape {out.shape} != ({k}, {m})")
    if out.nnz != a.nnz:
        raise ValueError("output nnz mismatch")
    if (out.ja.dtype != a.ja.dtype or out.vals.dtype != a.vals.dtype
            or out.ia.dtype != a.ia.dtype):
        # phase 2 views out's byte buffers with A's dtypes; a mismatch
        # would silently reinterpret/truncate instead of converting
        raise ValueError(
            f"output dtypes (ia {out.ia.dtype}, ja {out.ja.dtype}, vals "
            f"{out.vals.dtype}) must match A's ({a.ia.dtype}, "
            f"{a.ja.dtype}, {a.vals.dtype})")
    sched = ctx.scheduler()
    idt, vdt = a.ja.dtype, a.vals.dtype
    if m - 1 > np.iinfo(idt).max:
        # phase 1 stores GLOBAL row indices (A^T's column indices) in
        # A's ja dtype: a narrow index type that fit A's columns can
        # silently wrap on A's row count
        raise ValueError(
            f"csrcsc: {m} rows do not fit the index dtype {idt} "
            "(the transpose's column indices are A's row numbers); "
            "rebuild the matrix with int64 indices")

    ia_np = a.read_ia()
    blocks = fill_row_blocks(ia_np, cfg.max_nnzs)
    nb = len(blocks)

    # ---- phase 1: per-row-block transpose into scratch ------------------
    scratch_rows: List[Optional[FlashArray]] = [None] * nb
    scratch_vals: List[Optional[FlashArray]] = [None] * nb
    colptrs: List[Optional[np.ndarray]] = [None] * nb  # (k+1,) per block
    lock = threading.Lock()
    p1 = []
    try:
        for bi, (r, e) in enumerate(blocks):
            i0, i1 = int(ia_np[r]), int(ia_np[e])
            nnz_b = i1 - i0
            if nnz_b == 0:
                colptrs[bi] = np.zeros(k + 1, dtype=np.int64)
                continue
            scratch_rows[bi] = flash_empty((nnz_b,), idt, ctx=ctx)
            scratch_vals[bi] = flash_empty((nnz_b,), vdt, ctx=ctx)
            ja_off, ja_sin = a.ja.block_access(i0, nnz_b)
            va_off, va_sin = a.vals.block_access(i0, nnz_b)
            ro_off, ro_sin = scratch_rows[bi].block_access(0, nnz_b)
            vo_off, vo_sin = scratch_vals[bi].block_access(0, nnz_b)

            def run(task, bi=bi, r=r, e=e, ja_off=ja_off, ja_sin=ja_sin,
                    va_off=va_off, va_sin=va_sin, ro_off=ro_off, ro_sin=ro_sin,
                    vo_off=vo_off, vo_sin=vo_sin,
                    sr=scratch_rows[bi], sv=scratch_vals[bi]):
                import scipy.sparse as sps
                ja_blk = task.buf(a.ja.store, ja_off, ja_sin, idt)
                va_blk = task.buf(a.vals.store, va_off, va_sin, vdt)
                # compiled per-block transpose (the reference calls mkl_csrcsc
                # here, csrcsc_task.h; scipy's tocsc is the host equivalent —
                # ~20x faster than a numpy stable argsort + double gather).
                # Rows within a block ascend, so sorted-row csc order equals
                # the stable column sort's row order.
                blk_ia = (ia_np[r:e + 1] - ia_np[r]).astype(np.int64)
                csc = sps.csr_matrix((va_blk, ja_blk.astype(np.int64), blk_ia),
                                     shape=(e - r, k)).tocsc()
                task.buf(sr.store, ro_off, ro_sin, idt)[:] = \
                    csc.indices.astype(idt) + idt.type(r)
                task.buf(sv.store, vo_off, vo_sin, vdt)[:] = csc.data
                with lock:
                    colptrs[bi] = csc.indptr.astype(np.int64)
            t = FnTask(run)
            t.add_read(a.ja.store, ja_off, ja_sin)
            t.add_read(a.vals.store, va_off, va_sin)
            t.add_write(scratch_rows[bi].store, ro_off, ro_sin)
            t.add_write(scratch_vals[bi].store, vo_off, vo_sin)
            p1.append(t)
        sched.add_tasks(p1)
        sched.wait_for(p1)
        sched.flush_cache()  # barrier (reference: csrcsc.cpp:79-80)

        # ---- host: global transposed offsets --------------------------------
        total = np.zeros(k, dtype=np.int64)
        for cp in colptrs:
            total += np.diff(cp)
        ia_tr = np.zeros(k + 1, dtype=np.int64)
        np.cumsum(total, out=ia_tr[1:])
        if ia_tr[-1] != a.nnz:
            fatal("csrcsc lost entries: %d != %d", ia_tr[-1], a.nnz)
        out.ia.write_all(ia_tr)  # (reference writes ia_tr synchronously, :150)

        # ---- phase 2: merge column slices -----------------------------------
        col_blocks = fill_row_blocks(ia_tr, cfg.max_nnzs)
        p2 = []
        for (c0, c1) in col_blocks:
            o0, o1 = int(ia_tr[c0]), int(ia_tr[c1])
            if o1 == o0:
                continue
            frags = []  # (bi, frag_start, frag_len, lengths per col)
            for bi in range(nb):
                cp = colptrs[bi]
                f0, f1 = int(cp[c0]), int(cp[c1])
                if f1 > f0:
                    frags.append((bi, f0, f1 - f0,
                                  np.diff(cp[c0:c1 + 1]).astype(np.int64)))
            jo_off, jo_sin = out.ja.block_access(o0, o1 - o0)
            vo_off, vo_sin = out.vals.block_access(o0, o1 - o0)

            def run(task, frags=frags, c0=c0, c1=c1, o0=o0, o1=o1,
                    jo_off=jo_off, jo_sin=jo_sin, vo_off=vo_off, vo_sin=vo_sin):
                n_out = o1 - o0
                out_rows = task.buf(out.ja.store, jo_off, jo_sin, idt)
                out_vals = task.buf(out.vals.store, vo_off, vo_sin, vdt)
                if len(frags) == 1:
                    # single source block: the merged layout IS the fragment
                    bi, f0, flen, _lens = frags[0]
                    sr, sv = scratch_rows[bi], scratch_vals[bi]
                    r_off, r_sin = sr.block_access(f0, flen)
                    v_off, v_sin = sv.block_access(f0, flen)
                    out_rows[:] = task.buf(sr.store, r_off, r_sin, idt)
                    out_vals[:] = task.buf(sv.store, v_off, v_sin, vdt)
                    return
                # multi-block merge: concatenate the fragments in block order
                # with per-entry column ids, then ONE stable argsort by column
                # (bounded by max_nnzs — column blocks are nnz-budgeted).
                # Stability gives ascending source rows within each column.
                # NOTE: must NOT use scipy sparse addition here — it prunes
                # explicit zeros and sums duplicate (row, col) entries, both
                # legal in CSR inputs, corrupting the nnz accounting.
                cols_parts, rows_parts, vals_parts = [], [], []
                for bi, f0, flen, lens in frags:
                    sr, sv = scratch_rows[bi], scratch_vals[bi]
                    r_off, r_sin = sr.block_access(f0, flen)
                    v_off, v_sin = sv.block_access(f0, flen)
                    rows_parts.append(task.buf(sr.store, r_off, r_sin, idt))
                    vals_parts.append(task.buf(sv.store, v_off, v_sin, vdt))
                    cols_parts.append(np.repeat(
                        np.arange(c1 - c0, dtype=np.int32), lens))
                cols = np.concatenate(cols_parts)
                # native stable counting argsort (parallel on multi-core
                # hosts — the reference's OpenMP merge parity,
                # csrcsc_task.h:101-169); np.argsort fallback
                from ..io.native import counting_argsort_i32
                order = counting_argsort_i32(cols, c1 - c0)
                if order is None:
                    order = np.argsort(cols, kind="stable")
                out_rows[:] = np.concatenate(rows_parts)[order]
                out_vals[:] = np.concatenate(vals_parts)[order]
                assert len(cols) == n_out
            t = FnTask(run)
            for bi, f0, flen, _l in frags:
                sr, sv = scratch_rows[bi], scratch_vals[bi]
                t.add_read(sr.store, *sr.block_access(f0, flen))
                t.add_read(sv.store, *sv.block_access(f0, flen))
            t.add_write(out.ja.store, jo_off, jo_sin)
            t.add_write(out.vals.store, vo_off, vo_sin)
            p2.append(t)
        sched.add_tasks(p2)
        sched.wait_for(p2)
        sched.flush_cache()  # (reference: csrcsc.cpp:141-142)

    finally:
        # free scratch on EVERY path: a failed task raising out of
        # wait_for must not leak ~2x nnz bytes of scratch files per call
        from ..core.flash_array import flash_free
        for arr in scratch_rows + scratch_vals:
            if arr is not None:
                flash_free(arr)


def csrcsc_scratch(a: CsrFlashMatrix, ctx=None) -> CsrFlashMatrix:
    """Transpose into fresh scratch-backed arrays (used by csrmm 'T',
    reference: csrmm.cpp:364-420 flash_mallocs temporaries)."""
    ctx = ctx or a.ctx or get_context()
    m, k = a.shape
    ia = flash_empty((k + 1,), np.int64, ctx=ctx)
    ja = flash_empty((a.nnz,), a.ja.dtype, ctx=ctx)
    vals = flash_empty((a.nnz,), a.vals.dtype, ctx=ctx)
    out = CsrFlashMatrix(ia, ja, vals, (k, m))
    csrcsc(a, out, ctx=ctx)
    return out
