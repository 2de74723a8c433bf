"""TiledFlashArray — tile-major on-disk layout for out-of-core operands.

The reference stores matrices flat (row- or column-major), so a kernel
superblock read is a strided access: one small run per row, which is
IOPS-bound on O_DIRECT devices (the engine's span coalescing recovers the
sequential rate at <=4x byte amplification, bof_io.cpp span_read).  A
tile-major layout removes the amplification entirely: the array is stored
as a grid of fixed (ts x ts) zero-padded tiles, row-major over the tile
grid, each tile contiguous in storage-major element order — so every
tile-aligned superblock access is exactly ONE contiguous run of ts*ts
elements.  This is an extension beyond the reference (its format is flat
by definition, misc/dense_create.cpp); `repack`/`unpack` convert between
the two, and all kernels keep accepting flat arrays.

Access contract: `block_access` serves tile-grid-aligned requests
(r0 % ts == 0 and c0 % ts == 0, extents within one tile) and returns the
FULL stored tile — callers see storage shape (ts, ts) with zero padding,
which is exactly what the gemm pipeline's `pad_to` wanted to build anyway.
General unaligned windows go through the (slower) read_block/write_block
convenience paths, which decompose into tile visits on the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..context import FlashContext, get_context
from ..io.stride import StrideInfo
from .flash_array import FlashArray


class TiledFlashArray(FlashArray):
    """2-D FlashArray stored as a row-major grid of contiguous, zero-padded
    (tile x tile) storage-major tiles."""

    def __init__(self, store, shape: Tuple[int, int], dtype=np.float32,
                 order: str = "R", tile: int = 4096, offset: int = 0,
                 ctx: Optional[FlashContext] = None):
        if len(shape) != 2:
            raise ValueError("TiledFlashArray is 2-D only")
        super().__init__(store, shape, dtype, order, offset=offset, ctx=ctx)
        self.tile = int(tile)
        if self.tile <= 0:
            raise ValueError("tile must be positive")
        m, n = self.shape
        self._tr = -(-m // self.tile)  # tile-grid rows
        self._tc = -(-n // self.tile)

    @property
    def nbytes_stored(self) -> int:
        return self._tr * self._tc * self.tile * self.tile * self.itemsize

    def file_span(self):
        # base file_span would request one whole-array block_access,
        # which the tile-aligned accessor rejects; the padded grid is
        # contiguous from offset
        return self.offset, self.offset + self.nbytes_stored

    def _tile_off(self, ti: int, tj: int) -> int:
        tb = self.tile * self.tile * self.itemsize
        return self.offset + (ti * self._tc + tj) * tb

    # ------------------------------------------------- access specifiers
    def block_access(self, r0: int, nr: int, c0: int = 0,
                     nc: Optional[int] = None) -> Tuple[int, StrideInfo]:
        """Tile-aligned access: one contiguous run of the stored padded
        tile.  The returned buffer is ALWAYS (tile, tile) storage-major
        (see _block_shape_storage); tails are zero-padded in storage."""
        ts = self.tile
        nc = (self.shape[1] - c0) if nc is None else nc
        if r0 % ts or c0 % ts:
            raise ValueError(
                f"TiledFlashArray access must align to the {ts}-tile grid "
                f"(got r0={r0}, c0={c0}); use read_block/write_block for "
                "general windows")
        if nr > ts or nc > ts:
            raise ValueError(
                f"TiledFlashArray access must fit one tile (<= {ts}); "
                f"got ({nr}, {nc})")
        return (self._tile_off(r0 // ts, c0 // ts),
                StrideInfo.contiguous(ts * ts * self.itemsize))

    def _block_shape_storage(self, nr: int, nc: int):
        # the stored object is the full padded tile regardless of the
        # logical extent requested — consumers (ops/gemm.py _prep) use
        # this to reshape the gathered buffer
        return (self.tile, self.tile)

    # ---------------------------------------------------------- sync I/O
    def _read_tile(self, ti: int, tj: int) -> np.ndarray:
        ts = self.tile
        raw = self.store.read_sync(self._tile_off(ti, tj),
                                   StrideInfo.contiguous(
                                       ts * ts * self.itemsize))
        return raw.view(self.dtype).reshape(ts, ts)

    def _write_tile(self, ti: int, tj: int, tile_storage: np.ndarray):
        ts = self.tile
        buf = np.ascontiguousarray(tile_storage, dtype=self.dtype)
        assert buf.shape == (ts, ts)
        sinfo = StrideInfo.contiguous(ts * ts * self.itemsize)
        off = self._tile_off(ti, tj)
        self._invalidate(off, sinfo)
        self.store.write_sync(off, sinfo, buf.view(np.uint8).ravel())

    def read_block(self, r0: int, nr: int, c0: int = 0,
                   nc: Optional[int] = None) -> np.ndarray:
        """General logical window: decomposes into tile visits (slow
        convenience path for verify windows / host-side steps)."""
        nc = (self.shape[1] - c0) if nc is None else nc
        ts = self.tile
        out = np.empty((nr, nc), self.dtype)
        r = r0
        while r < r0 + nr:
            ti = r // ts
            r_hi = min((ti + 1) * ts, r0 + nr)
            c = c0
            while c < c0 + nc:
                tj = c // ts
                c_hi = min((tj + 1) * ts, c0 + nc)
                t = self._read_tile(ti, tj)
                if self.order == "C":
                    t = t.T
                out[r - r0:r_hi - r0, c - c0:c_hi - c0] = \
                    t[r - ti * ts:r_hi - ti * ts, c - tj * ts:c_hi - tj * ts]
                c = c_hi
            r = r_hi
        return out

    def write_block(self, r0: int, data: np.ndarray, c0: int = 0):
        """General logical window write: read-modify-write per touched
        tile (full-tile writes skip the read)."""
        data = np.ascontiguousarray(data, dtype=self.dtype)
        nr, nc = data.shape
        ts = self.tile
        r = r0
        while r < r0 + nr:
            ti = r // ts
            r_hi = min((ti + 1) * ts, r0 + nr)
            c = c0
            while c < c0 + nc:
                tj = c // ts
                c_hi = min((tj + 1) * ts, c0 + nc)
                full = (r == ti * ts and r_hi == (ti + 1) * ts
                        and c == tj * ts and c_hi == (tj + 1) * ts)
                t = (np.zeros((ts, ts), self.dtype) if full
                     else self._read_tile(ti, tj))
                if self.order == "C":
                    t = t.T  # logical view; transposed back on write
                t[r - ti * ts:r_hi - ti * ts,
                  c - tj * ts:c_hi - tj * ts] = \
                    data[r - r0:r_hi - r0, c - c0:c_hi - c0]
                self._write_tile(ti, tj, t.T if self.order == "C" else t)
                c = c_hi
            r = r_hi

    def read_block_storage(self, r0: int, nr: int, c0: int,
                           nc: int) -> np.ndarray:
        """Tile-aligned storage-major read: the full padded (ts, ts)
        tile (what the device pipeline consumes)."""
        off, sinfo = self.block_access(r0, nr, c0, nc)
        raw = self.store.read_sync(off, sinfo)
        return raw.view(self.dtype).reshape(self.tile, self.tile)

    def write_block_storage(self, r0: int, c0: int, nr: int, nc: int,
                            storage_buf: np.ndarray):
        buf = self._coerce_tile(storage_buf, r0, c0, nr, nc)
        off, sinfo = self.block_access(r0, nr, c0, nc)
        self._invalidate(off, sinfo)
        self.store.write_sync(off, sinfo, buf.view(np.uint8).ravel())

    def write_block_storage_async(self, r0: int, c0: int, nr: int, nc: int,
                                  storage_buf: np.ndarray):
        buf = self._coerce_tile(storage_buf, r0, c0, nr, nc)
        off, sinfo = self.block_access(r0, nr, c0, nc)
        self._invalidate(off, sinfo)
        return self.store.write(off, sinfo, buf.view(np.uint8).ravel())

    def write_tile_rows_async(self, r0: int, c0: int, row0: int,
                              rows_buf: np.ndarray):
        """Storage rows [row0, row0 + len(rows_buf)) of the stored tile
        at the tile-aligned logical (r0, c0), as one contiguous run:
        the gemm writers hand a finished tile over in runs of whole
        (tile-wide, padding included) rows."""
        ts = self.tile
        buf = np.ascontiguousarray(rows_buf, dtype=self.dtype)
        if r0 % ts or c0 % ts:
            raise ValueError(f"({r0}, {c0}) is not on the {ts}-tile grid")
        if (buf.ndim != 2 or buf.shape[1] != ts
                or not 0 <= row0 <= ts - buf.shape[0]):
            raise ValueError(f"rows {row0}.. of shape {buf.shape} are not "
                             f"whole rows of a ({ts}, {ts}) tile")
        off = self._tile_off(r0 // ts, c0 // ts) + row0 * ts * self.itemsize
        sinfo = StrideInfo.contiguous(buf.nbytes)
        self._invalidate(off, sinfo)
        return self.store.write(off, sinfo, buf.view(np.uint8).ravel())

    def _coerce_tile(self, storage_buf: np.ndarray, r0: int, c0: int,
                     nr: int, nc: int) -> np.ndarray:
        """Accept either the full (ts, ts) padded buffer (the gemm writer
        hands it over un-sliced) or an exact (nr, nc) storage-major tail
        block, zero-padding the latter.  A partial window is only legal
        when it IS the tile's full logical extent (a grid-edge tail):
        zero-padding an interior partial window would overwrite the
        co-resident rows/columns the caller does not own with zeros —
        silent data loss, so it must be a loud error (general windows go
        through write_block's read-modify-write path)."""
        ts = self.tile
        buf = np.ascontiguousarray(storage_buf, dtype=self.dtype)
        if buf.shape == (ts, ts):
            return buf
        want = (min(ts, self.shape[0] - r0), min(ts, self.shape[1] - c0))
        if (nr, nc) != want:
            raise ValueError(
                f"partial window ({nr}, {nc}) at ({r0}, {c0}) is not this "
                f"tile's full logical extent {want}: zero-padding it "
                "would destroy the tile's other valid data — use "
                "write_block (RMW) for general windows")
        st = (nr, nc) if self.order == "R" else (nc, nr)
        if buf.shape != st:
            raise ValueError(f"expected {st} or {(ts, ts)}, got {buf.shape}")
        out = np.zeros((ts, ts), self.dtype)
        out[:buf.shape[0], :buf.shape[1]] = buf
        return out

    def as_memmap(self, mode: str = "r+"):
        raise TypeError("as_memmap is undefined for tile-major storage; "
                        "unpack to a flat layout first (drivers/repack)")

    def ravel_view(self):
        raise TypeError("ravel_view is undefined for tile-major storage")

    def __repr__(self):
        return (f"TiledFlashArray(shape={self.shape}, dtype={self.dtype}, "
                f"order={self.order}, tile={self.tile})")


# ----------------------------------------------------------- constructors
def map_tiled_array(path: str, shape, dtype=np.float32, order: str = "R",
                    tile: int = 4096, create: bool = False,
                    ctx: Optional[FlashContext] = None,
                    o_direct: Optional[bool] = None) -> TiledFlashArray:
    """Open (or create) a tile-major file as a TiledFlashArray."""
    ctx = ctx or get_context()
    ts = int(tile)
    m, n = (int(s) for s in shape)
    nbytes = (-(-m // ts)) * (-(-n // ts)) * ts * ts * np.dtype(dtype).itemsize
    store = ctx.open_store(path, create=create,
                           truncate_to=nbytes if create else 0,
                           o_direct=o_direct)
    if not create and store.size() < nbytes:
        raise IOError(f"{path}: file smaller than the padded tile grid "
                      f"({store.size()} < {nbytes})")
    return TiledFlashArray(store, (m, n), dtype, order, tile=ts, ctx=ctx)


def repack(src: FlashArray, dst: TiledFlashArray) -> None:
    """Flat -> tile-major conversion, one tile at a time (reference data
    files stay flat, misc/dense_create.cpp; this materializes the blocked
    twin)."""
    _check_pair(src, dst)
    ts = dst.tile
    m, n = src.shape
    for ti in range(dst._tr):
        r0 = ti * ts
        nr = min(ts, m - r0)
        for tj in range(dst._tc):
            c0 = tj * ts
            nc = min(ts, n - c0)
            t = np.zeros((ts, ts), dst.dtype)
            blk = src.read_block(r0, nr, c0, nc)
            if dst.order == "R":
                t[:nr, :nc] = blk
            else:
                t[:nc, :nr] = blk.T
            dst._write_tile(ti, tj, t)
    dst.store.flush()


def unpack(src: TiledFlashArray, dst: FlashArray) -> None:
    """Tile-major -> flat conversion."""
    _check_pair(dst, src)
    ts = src.tile
    m, n = src.shape
    for ti in range(src._tr):
        r0 = ti * ts
        nr = min(ts, m - r0)
        for tj in range(src._tc):
            c0 = tj * ts
            nc = min(ts, n - c0)
            t = src._read_tile(ti, tj)
            if src.order == "C":
                t = t.T
            dst.write_block(r0, t[:nr, :nc], c0)
    dst.store.flush()


def _check_pair(flat: FlashArray, tiled: TiledFlashArray) -> None:
    if flat.shape != tiled.shape:
        raise ValueError(f"shape mismatch: {flat.shape} vs {tiled.shape}")
    if flat.dtype != tiled.dtype:
        raise ValueError("dtype mismatch")


def check_tile_blk(named_arrays, sb: int):
    """Shared guard: every tile-major operand's tile edge must equal the
    kernel superblock (gemm/gemm64/gemm_sharded all require blk == tile
    so each superblock read is ONE contiguous run).  One helper instead
    of per-kernel copies that drift."""
    for name, arr in named_arrays:
        t = getattr(arr, "tile", None)
        if t is not None and t != sb:
            raise ValueError(
                f"operand {name} is tile-major with tile {t}; the kernel "
                f"blk must match (got {sb})")


def reject_tiled(named_arrays, why: str):
    """Shared guard for kernels whose access pattern is incompatible with
    tile-major storage (e.g. nnz-adaptive row blocks)."""
    for name, arr in named_arrays:
        if getattr(arr, "tile", None) is not None:
            raise ValueError(
                f"operand {name} is tile-major, unsupported here: {why}")
