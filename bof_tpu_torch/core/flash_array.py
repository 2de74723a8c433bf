"""FlashArray — a typed array handle over a byte store.

The TPU-native analog of the reference's `flash_ptr<T>` + `map_file`
(reference: include/pointers/pointer.h:14-60, include/pointers/
allocator.h:19-59): a (store, byte-offset) pair plus dtype/shape/layout
metadata, with block-granular strided access instead of raw pointer
arithmetic.  2-D arrays carry a leading dimension (`ld`, in elements) so
sub-matrices of larger on-disk matrices are first-class, matching the
reference kernels' `lda` support (reference: src/blas/gemm.cpp:44-67).

Layout convention: `order='R'` stores row-major (element (i,j) at
offset + (i*ld + j)*itemsize), `order='C'` column-major (element (i,j) at
offset + (j*ld + i)*itemsize).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..context import FlashContext, get_context
from ..io.store import BaseStore, MemStore, Ticket
from ..io.stride import StrideInfo


class FlashArray:
    def __init__(self, store: BaseStore, shape: Tuple[int, ...],
                 dtype=np.float32, order: str = "R", offset: int = 0,
                 ld: Optional[int] = None,
                 ctx: Optional[FlashContext] = None):
        if len(shape) not in (1, 2):
            raise ValueError("FlashArray supports 1-D and 2-D shapes")
        if order not in ("R", "C"):
            raise ValueError("order must be 'R' or 'C'")
        self.store = store
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.order = order
        self.offset = int(offset)
        if len(self.shape) == 2:
            default_ld = self.shape[1] if order == "R" else self.shape[0]
            self.ld = int(ld) if ld is not None else default_ld
        else:
            self.ld = int(ld) if ld is not None else self.shape[0]
        self.ctx = ctx or get_context()

    # ------------------------------------------------------------- helpers
    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.itemsize

    def __repr__(self):
        return (f"FlashArray(shape={self.shape}, dtype={self.dtype}, "
                f"order={self.order}, offset={self.offset}, ld={self.ld})")

    def file_span(self) -> Tuple[int, int]:
        """[lo, hi) byte range this array touches in its store (covers the
        ld gaps — the aliasing granularity, not the transferred bytes)."""
        if int(np.prod(self.shape)) == 0:
            return self.offset, self.offset
        if len(self.shape) == 1:
            return self.offset, self.offset + self.shape[0] * self.itemsize
        off, sinfo = self.block_access(0, self.shape[0], 0, self.shape[1])
        return off, off + sinfo.file_extent

    # ------------------------------------------------- access specifiers
    def block_access(self, r0: int, nr: int, c0: int = 0,
                     nc: Optional[int] = None) -> Tuple[int, StrideInfo]:
        """(byte offset, StrideInfo) for logical block [r0:r0+nr, c0:c0+nc].
        The contiguous buffer side is storage-major: row-major blocks gather
        rows, column-major blocks gather columns."""
        it = self.itemsize
        if len(self.shape) == 1:
            if nc is not None and nc != 1:
                raise ValueError("1-D array block takes rows only")
            off = self.offset + r0 * it
            return off, StrideInfo.contiguous(nr * it)
        nc = self.shape[1] - c0 if nc is None else nc
        if self.order == "R":
            off = self.offset + (r0 * self.ld + c0) * it
            if nc == self.ld:  # full-width rows are contiguous
                return off, StrideInfo.contiguous(nr * nc * it)
            return off, StrideInfo(stride=self.ld * it, n_strides=nr,
                                   len_per_stride=nc * it)
        off = self.offset + (c0 * self.ld + r0) * it
        if nr == self.ld:
            return off, StrideInfo.contiguous(nr * nc * it)
        return off, StrideInfo(stride=self.ld * it, n_strides=nc,
                               len_per_stride=nr * it)

    def _block_shape_storage(self, nr: int, nc: int):
        """Shape of the gathered buffer viewed storage-major."""
        return (nr, nc) if self.order == "R" else (nc, nr)

    def _invalidate(self, off: int, sinfo: StrideInfo) -> None:
        """Cache-coherence hook: every direct write drops overlapping
        cached tiles so later kernel reads re-fetch (the reference instead
        flushes the whole Program Cache at kernel boundaries,
        cache.cpp:45-70; we retain tiles across kernels)."""
        if self.ctx is not None:
            self.ctx.coherence_invalidate(self.store, off, sinfo)

    # ---------------------------------------------------------- sync I/O
    def read_block(self, r0: int, nr: int, c0: int = 0,
                   nc: Optional[int] = None) -> np.ndarray:
        """Read block as a logical (nr, nc) ndarray (1-D: (nr,))."""
        off, sinfo = self.block_access(r0, nr, c0, nc)
        raw = self.store.read_sync(off, sinfo)
        if len(self.shape) == 1:
            return raw.view(self.dtype)
        nc = self.shape[1] - c0 if nc is None else nc
        arr = raw.view(self.dtype).reshape(self._block_shape_storage(nr, nc))
        return arr if self.order == "R" else arr.T

    def write_block(self, r0: int, data: np.ndarray, c0: int = 0):
        data = np.ascontiguousarray(data, dtype=self.dtype)
        if len(self.shape) == 1:
            off, sinfo = self.block_access(r0, data.shape[0])
            self._invalidate(off, sinfo)
            self.store.write_sync(off, sinfo, data.view(np.uint8).ravel())
            return
        nr, nc = data.shape
        off, sinfo = self.block_access(r0, nr, c0, nc)
        self._invalidate(off, sinfo)
        storage = data if self.order == "R" else np.ascontiguousarray(data.T)
        self.store.write_sync(off, sinfo, storage.view(np.uint8).ravel())

    def read_all(self) -> np.ndarray:
        if len(self.shape) == 1:
            return self.read_block(0, self.shape[0])
        return self.read_block(0, self.shape[0], 0, self.shape[1])

    def write_all(self, data: np.ndarray):
        self.write_block(0, np.asarray(data).reshape(self.shape)
                         if len(self.shape) > 1 else np.asarray(data))

    # --------------------------------------------------------- async I/O
    def read_block_async(self, r0: int, nr: int, c0: int, nc: int,
                         out: np.ndarray) -> Ticket:
        off, sinfo = self.block_access(r0, nr, c0, nc)
        return self.store.read(off, sinfo, out)

    def write_block_async(self, r0: int, nr: int, c0: int, nc: int,
                          src: np.ndarray) -> Ticket:
        off, sinfo = self.block_access(r0, nr, c0, nc)
        self._invalidate(off, sinfo)
        return self.store.write(off, sinfo, src)

    # ----------------------------------------- storage-major block I/O
    # The device pipeline reads blocks in storage-major layout and lets the
    # MXU's dot_general absorb the transpose — no host-side transposition.
    def read_block_storage(self, r0: int, nr: int, c0: int,
                           nc: int) -> np.ndarray:
        """Gathered block as a storage-major 2-D array: (nr, nc) for
        row-major arrays, (nc, nr) for column-major."""
        off, sinfo = self.block_access(r0, nr, c0, nc)
        raw = self.store.read_sync(off, sinfo)
        return raw.view(self.dtype).reshape(self._block_shape_storage(nr, nc))

    def write_block_storage(self, r0: int, c0: int, nr: int, nc: int,
                            storage_buf: np.ndarray):
        """Write a block given already-storage-major contiguous data."""
        off, sinfo = self.block_access(r0, nr, c0, nc)
        self._invalidate(off, sinfo)
        self.store.write_sync(off, sinfo,
                              np.ascontiguousarray(storage_buf)
                              .view(np.uint8).ravel())

    def write_block_storage_async(self, r0: int, c0: int, nr: int, nc: int,
                                  storage_buf: np.ndarray) -> Ticket:
        off, sinfo = self.block_access(r0, nr, c0, nc)
        self._invalidate(off, sinfo)
        flat = np.ascontiguousarray(storage_buf).view(np.uint8).ravel()
        return self.store.write(off, sinfo, flat)

    # ------------------------------------------------------------- views
    def as_memmap(self, mode: str = "r+") -> np.ndarray:
        """Memory-mapped raw view for direct host access (reference:
        map_file also mmaps the file so get_raw_ptr() works outside the
        scheduler, allocator.h:19-45; the kmeans driver argmins through
        it, drivers/kmeans.cpp:94-99).  File-backed stores only; the
        caller must not mix mmap writes with in-flight scheduler writes
        to the same region.  ld-padded sub-matrices map with the real
        leading-dimension stride, so only the view's own bytes are
        touched."""
        path = getattr(self.store, "path", None)
        if path is None:
            raise TypeError("as_memmap needs a file-backed store")
        if len(self.shape) == 1:
            return np.memmap(path, dtype=self.dtype, mode=mode,
                             offset=self.offset, shape=self.shape)
        lines, width = self._block_shape_storage(*self.shape)
        if self.ld == width:
            mm = np.memmap(path, dtype=self.dtype, mode=mode,
                           offset=self.offset, shape=(lines, width))
        else:
            # map exactly the spanned elements 1-D, then stride by ld —
            # a contiguous (lines, width) map would read/write the
            # parent matrix's neighboring bytes
            span = (lines - 1) * self.ld + width
            flat = np.memmap(path, dtype=self.dtype, mode=mode,
                             offset=self.offset, shape=(span,))
            mm = np.lib.stride_tricks.as_strided(
                flat, shape=(lines, width),
                strides=(self.ld * self.itemsize, self.itemsize))
        return mm.T if self.order == "C" else mm

    def vec_view(self, start: int, n: int) -> "FlashArray":
        """1-D sub-view (flash_ptr + offset arithmetic analog)."""
        if len(self.shape) != 1:
            raise ValueError("vec_view on 1-D arrays only")
        return FlashArray(self.store, (n,), self.dtype, "R",
                          self.offset + start * self.itemsize, ctx=self.ctx)

    def ravel_view(self) -> "FlashArray":
        """Flat 1-D view over a densely-stored array (no ld padding) —
        lets the 1-D streaming ops (map/reduce/sort) run over matrices,
        like the reference's elementwise lib funcs over flash_ptr<T>."""
        if len(self.shape) == 1:
            return self
        dense_ld = self.shape[1] if self.order == "R" else self.shape[0]
        if self.ld != dense_ld:
            raise ValueError("ravel_view needs a densely-stored array "
                             f"(ld {self.ld} != {dense_ld})")
        n = int(np.prod(self.shape))
        return FlashArray(self.store, (n,), self.dtype, "R", self.offset,
                          ctx=self.ctx)


# ----------------------------------------------------------- constructors
def check_output_distinct(out: "FlashArray", **inputs) -> None:
    """Reject an output array whose bytes alias any input's: every kernel
    streams input tiles while the writer persists output tiles, so an
    aliasing output would be consumed half-written (the same hazard class
    bof_sort/bof_map guard against; inode-level identity because two
    open_store calls on one path get distinct uids).  `beta`-style reads
    of the output itself are NOT inputs here — they share the output's
    cache keys by construction."""
    from ..io.store import same_backing
    o_lo, o_hi = out.file_span()
    if o_hi <= o_lo:
        return
    for name, arr in inputs.items():
        if arr is None:
            continue
        i_lo, i_hi = arr.file_span()
        if (same_backing(out.store, arr.store)
                and o_lo < i_hi and i_lo < o_hi):
            raise ValueError(
                f"output bytes [{o_lo}, {o_hi}) alias input '{name}' "
                f"[{i_lo}, {i_hi}) in the same file: the kernel reads "
                "inputs while writing the output, so aliasing would "
                "consume half-written tiles — use a distinct output "
                "file or range")


def map_array(path: str, shape, dtype=np.float32, order: str = "R",
              create: bool = False, ctx: Optional[FlashContext] = None,
              o_direct: Optional[bool] = None, offset: int = 0,
              ld: Optional[int] = None) -> FlashArray:
    """Open a file as a FlashArray (reference: map_file, allocator.h:19-45).

    `ld` maps an ld-padded sub-matrix in place (reference gemm's
    lda_a/lda_b/lda_c arguments, src/blas/gemm.cpp:44-67): the file holds
    `ld` elements per storage line, of which shape[] are the logical
    extent.  `offset` is the byte position of element (0, 0)."""
    ctx = ctx or get_context()
    it = np.dtype(dtype).itemsize
    if len(tuple(shape)) == 2:
        lines = shape[0] if order == "R" else shape[1]
        width = shape[1] if order == "R" else shape[0]
        eff_ld = int(ld) if ld is not None else width
        if eff_ld < width:
            raise ValueError(f"ld {eff_ld} smaller than the storage line "
                             f"width {width}")
        nbytes = offset + (((lines - 1) * eff_ld + width) * it
                           if lines > 0 else 0)
    else:
        nbytes = offset + int(np.prod(shape)) * it
    store = ctx.open_store(path, create=create,
                           truncate_to=nbytes if create else 0,
                           o_direct=o_direct)
    if not create and store.size() < nbytes:
        raise IOError(f"{path}: file smaller than requested array "
                      f"({store.size()} < {nbytes})")
    return FlashArray(store, shape, dtype, order, offset=offset, ld=ld,
                      ctx=ctx)


def flash_empty(shape, dtype=np.float32, order: str = "R",
                ctx: Optional[FlashContext] = None) -> FlashArray:
    """Scratch-file-backed array (reference: flash_malloc,
    lib_funcs.h:103-120)."""
    ctx = ctx or get_context()
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return FlashArray(ctx.scratch_store(nbytes), shape, dtype, order, ctx=ctx)


def flash_free(arr: FlashArray):
    arr.ctx.free_scratch(arr.store)


def mem_array(shape, dtype=np.float32, order: str = "R",
              data: Optional[np.ndarray] = None,
              ctx: Optional[FlashContext] = None) -> FlashArray:
    """DRAM-backed FlashArray over MemStore — the no-SSD test seam
    (reference: MemFileHandle)."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    arr = FlashArray(MemStore(nbytes), shape, dtype, order, ctx=ctx)
    if data is not None:
        arr.write_all(np.asarray(data, dtype=dtype))
    return arr
