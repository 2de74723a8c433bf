"""Flash-resident CSR matrices (host code, as in bof_tpu/sparse/csr.py).

The reference stores a CSR operand as three raw files — offsets (.off,
64-bit), column indices (.col, 64-bit), values (.csr, fp32) (reference:
misc/sparse_create.cpp + misc/README.md:8-12) — and passes three
flash_ptrs to every sparse kernel.  `CsrFlashMatrix` bundles the same
triplet of FlashArrays with the logical shape.

`fill_row_blocks` is the adaptive row blocking by nnz budget (reference:
get_next_blk_size/fill_blocks, include/blas_utils.h:72-97): row blocks are
grown until they hold ~max_nnzs nonzeros, so every sparse task touches a
bounded working set regardless of row skew.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..context import FlashContext, get_context
from ..core.flash_array import FlashArray, flash_empty, map_array, mem_array


class CsrFlashMatrix:
    def __init__(self, ia: FlashArray, ja: FlashArray, vals: FlashArray,
                 shape: Tuple[int, int]):
        m, k = shape
        if ia.shape != (m + 1,):
            raise ValueError(f"ia shape {ia.shape} != ({m + 1},)")
        if ja.shape != vals.shape:
            raise ValueError("ja/vals length mismatch")
        self.ia, self.ja, self.vals = ia, ja, vals
        self.shape = (int(m), int(k))

    @property
    def nnz(self) -> int:
        return self.ja.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def ctx(self):
        return self.ia.ctx

    # ------------------------------------------------------- constructors
    @classmethod
    def from_scipy(cls, sp, backing: str = "mem",
                   path_prefix: Optional[str] = None,
                   ctx: Optional[FlashContext] = None,
                   idx_dtype=np.int64,
                   val_dtype=np.float32) -> "CsrFlashMatrix":
        """Build from a scipy.sparse matrix (tests / ingestion).
        `val_dtype` defaults to float32 (FP_SINGLE_PRECISION, the
        reference default); pass np.float64 for FP_DOUBLE_PRECISION
        semantics (bof_types.h:24-42) — the kernels keep fp64 exact via
        host compute."""
        sp = sp.tocsr()
        sp.sort_indices()
        m, k = sp.shape
        ia_np = sp.indptr.astype(np.int64)
        ja_np = sp.indices.astype(idx_dtype)
        va_np = sp.data.astype(val_dtype)
        ctx = ctx or get_context()
        if backing == "mem":
            ia = mem_array((m + 1,), np.int64, data=ia_np, ctx=ctx)
            ja = mem_array((len(ja_np),), idx_dtype, data=ja_np, ctx=ctx)
            va = mem_array((len(va_np),), val_dtype, data=va_np, ctx=ctx)
        elif backing == "file":
            ia = map_array(path_prefix + ".off", (m + 1,), np.int64,
                           create=True, ctx=ctx)
            ja = map_array(path_prefix + ".col", (len(ja_np),), idx_dtype,
                           create=True, ctx=ctx)
            va = map_array(path_prefix + ".csr", (len(va_np),), val_dtype,
                           create=True, ctx=ctx)
            ia.write_all(ia_np)
            ja.write_all(ja_np)
            va.write_all(va_np)
        else:  # scratch
            ia = flash_empty((m + 1,), np.int64, ctx=ctx)
            ja = flash_empty((len(ja_np),), idx_dtype, ctx=ctx)
            va = flash_empty((len(va_np),), val_dtype, ctx=ctx)
            ia.write_all(ia_np)
            ja.write_all(ja_np)
            va.write_all(va_np)
        return cls(ia, ja, va, (m, k))

    @classmethod
    def map_files(cls, prefix: str, shape: Tuple[int, int],
                  idx_dtype=np.int64, val_dtype=np.float32,
                  ctx: Optional[FlashContext] = None) -> "CsrFlashMatrix":
        """Open the reference's .off/.col/.csr triplet."""
        ctx = ctx or get_context()
        m, k = shape
        ia = map_array(prefix + ".off", (m + 1,), np.int64, ctx=ctx)
        nnz = ia.read_block(m, 1)[0]
        ja = map_array(prefix + ".col", (int(nnz),), idx_dtype, ctx=ctx)
        va = map_array(prefix + ".csr", (int(nnz),), val_dtype, ctx=ctx)
        return cls(ia, ja, va, shape)

    # ------------------------------------------------------------ helpers
    def read_ia(self) -> np.ndarray:
        """Whole offsets array, read synchronously (the reference planners
        do exactly this, e.g. csrmm.cpp:69-71)."""
        return self.ia.read_all()

    def to_scipy(self):
        import scipy.sparse as sps
        return sps.csr_matrix(
            (self.vals.read_all(), self.ja.read_all(), self.read_ia()),
            shape=self.shape)


def verify_csr_block(ia_blk: np.ndarray, ja_blk: np.ndarray, n_cols: int,
                     nnz_expected: int = -1) -> None:
    """Structural CSR block validation (reference: verify_csr_block,
    include/blas_utils.h:100-141 — compiled only under DEBUG; here gated
    by FlashConfig/log level at call sites).  Checks monotone offsets and
    column bounds; raises ValueError on corruption."""
    if len(ia_blk) < 2:
        raise ValueError("csr block needs at least one row")
    d = np.diff(ia_blk)
    if (d < 0).any():
        raise ValueError("csr offsets not monotone")
    nnz = int(ia_blk[-1] - ia_blk[0])
    if nnz != len(ja_blk):
        raise ValueError(f"csr offsets/nnz mismatch: {nnz} != {len(ja_blk)}")
    if nnz_expected >= 0 and nnz != nnz_expected:
        raise ValueError(f"csr nnz {nnz} != expected {nnz_expected}")
    if nnz and (int(ja_blk.min()) < 0 or int(ja_blk.max()) >= n_cols):
        raise ValueError("csr column index out of range")


def stream_row_blocks(a: "CsrFlashMatrix", ia_np: np.ndarray,
                      blocks: List[Tuple[int, int]], ctx,
                      depth: Optional[int] = None):
    """Generator yielding (r, e, ja_blk, va_blk) for nnz-budgeted CSR row
    blocks, prefetched through the pinned tile cache — the shared
    stream-A skeleton of every sparse planner (csrmm 'T' streaming, the
    eigensolvers' one-pass operator, xml_rank's fused pass).  Each block's
    buffers are pin-cache views valid only until the next iteration.
    Honors FlashConfig.debug_checks (verify_csr_block, the reference's
    DEBUG validation).  Closing the generator (break / exception in the
    consumer) releases all pins."""
    from ..core.pipeline import PrefetchSeq

    cfg = ctx.config
    idt, vdt = a.ja.dtype, a.vals.dtype
    accesses = []
    for r, e in blocks:
        i0, i1 = int(ia_np[r]), int(ia_np[e])
        accesses.append((a.ja.store,) + a.ja.block_access(i0, i1 - i0))
        accesses.append((a.vals.store,) + a.vals.block_access(i0, i1 - i0))
    pf = PrefetchSeq(cache=ctx.pin_cache(), accesses=accesses,
                     depth=depth or 2 * cfg.pipeline_depth)
    try:
        for bi, (r, e) in enumerate(blocks):
            i0, i1 = int(ia_np[r]), int(ia_np[e])
            ja_blk = pf.get(2 * bi).view(idt)
            va_blk = pf.get(2 * bi + 1).view(vdt)
            if cfg.debug_checks:
                verify_csr_block(ia_np[r:e + 1], ja_blk, a.shape[1],
                                 i1 - i0)
            yield r, e, ja_blk, va_blk
            pf.done(2 * bi)
            pf.done(2 * bi + 1)
    finally:
        pf.close()


def fill_row_blocks(ia_np: np.ndarray, max_nnzs: int) -> List[Tuple[int, int]]:
    """Adaptive row blocks each holding <= max_nnzs nonzeros (>=1 row)
    (reference: fill_blocks, blas_utils.h:84-97)."""
    m = len(ia_np) - 1
    blocks = []
    r = 0
    while r < m:
        # largest e with ia[e] - ia[r] <= max_nnzs, at least r+1
        e = int(np.searchsorted(ia_np, ia_np[r] + max_nnzs, side="right")) - 1
        e = max(e, r + 1)
        e = min(e, m)
        blocks.append((r, e))
        r = e
    return blocks
