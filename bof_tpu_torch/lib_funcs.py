"""Flash memory/utility functions (reference: include/lib_funcs.h), as
bof_tpu's `lib_funcs.py` has them: host-only, streamed through the
port's store API.

The reference exposes flash_malloc/flash_free (scratch files),
flash_memset/flash_memcpy, read_sync/write_sync and flash_truncate over
flash_ptrs (lib_funcs.h:49-128), plus strided flash-to-flash copy
(BaseFileHandle::copy/scopy, file_handle.h:59-73).  The allocation pair
lives in core/flash_array.py (flash_empty/flash_free); the block-wise
memory ops live here, streamed through the store API so they work on
operands far larger than RAM.  ld-padded sub-matrices are handled by
streaming storage-major line groups through block_access, so the padding
bytes of the parent matrix are never touched.
"""
from __future__ import annotations

import numpy as np

from .core.flash_array import FlashArray
from .io.stride import StrideInfo

_CHUNK = 64 << 20  # stream granularity in bytes


def _dense(arr: FlashArray) -> bool:
    """True when the array's bytes are contiguous (no ld padding)."""
    if len(arr.shape) == 1:
        return True
    return arr.ld == (arr.shape[1] if arr.order == "R" else arr.shape[0])


def _line_chunks(arr: FlashArray):
    """Yield (offset, StrideInfo) covering a 2-D array in storage-major
    line groups of <= ~_CHUNK bytes each, honoring ld."""
    m, n = arr.shape
    lines = m if arr.order == "R" else n
    line_bytes = (n if arr.order == "R" else m) * arr.itemsize
    per = max(1, _CHUNK // max(1, line_bytes))
    for l0 in range(0, lines, per):
        nl = min(per, lines - l0)
        if arr.order == "R":
            yield arr.block_access(l0, nl, 0, n)
        else:
            yield arr.block_access(0, m, l0, nl)


def flash_memset(arr: FlashArray, byte_value: int = 0) -> None:
    """Fill an array's backing bytes (reference: flash_memset,
    lib_funcs.h:49-54).  ld-padded sub-matrices only touch their own
    rows/columns, never the parent matrix's neighboring bytes."""
    from .core.pipeline import TicketWindow
    tickets = TicketWindow(depth=8)
    if _dense(arr):
        total = arr.nbytes
        arr._invalidate(arr.offset, StrideInfo.contiguous(total))
        chunk = np.full(min(_CHUNK, total), byte_value, np.uint8)
        off, done = arr.offset, 0
        while done < total:
            c = min(len(chunk), total - done)
            tickets.push(arr.store.write(
                off + done, StrideInfo.contiguous(c), chunk[:c]))
            done += c
    else:
        # one conservative invalidate for the whole written span (the
        # byte range already covers the ld gaps via file_extent) instead
        # of a full-cache sweep per line group
        off0, si0 = arr.block_access(0, arr.shape[0], 0, arr.shape[1])
        arr._invalidate(off0, si0)
        chunk = None
        for off, sinfo in _line_chunks(arr):
            if chunk is None or len(chunk) < sinfo.nbytes:
                chunk = np.full(sinfo.nbytes, byte_value, np.uint8)
            tickets.push(arr.store.write(off, sinfo,
                                           chunk[:sinfo.nbytes]))
    tickets.wait_all()
    arr.store.flush()


def flash_memcpy(dst: FlashArray, src: FlashArray) -> None:
    """Copy src into dst, streamed in chunks (reference: flash_memcpy,
    lib_funcs.h:56-60; FlashFileHandle::copy goes read->DRAM->write the
    same way, flash_file_handle.cpp:409-427).  Dense arrays of equal byte
    size copy contiguously; ld-padded and mixed-layout 2-D arrays stream
    logical row blocks through strided scopy (flash_file_handle.cpp:
    718-727), transposing on the host only when orders differ."""
    def _byte_compatible():
        """Raw byte copy preserves logical contents: 1-D either side, or
        equal storage orders, or the transpose-reinterpret case (orders
        differ AND shapes are transposed — same byte layout).  An
        equal-shape mixed-order pair must NOT take this path: the bytes
        would land transposed.  Square shapes are both equal AND
        reversed-equal — the logical-copy contract wins there."""
        if len(dst.shape) == 1 or len(src.shape) == 1:
            return True
        if dst.order == src.order:
            return True
        return (dst.shape == src.shape[::-1]
                and dst.shape != src.shape)

    from .core.pipeline import TicketWindow
    pending = TicketWindow(depth=8)  # each scopy ticket holds a _CHUNK buf
    if _dense(dst) and _dense(src) and _byte_compatible():
        # raw byte copy, like the reference's flash_memcpy over flash_ptrs
        if dst.nbytes != src.nbytes:
            raise ValueError(f"size mismatch: {dst.nbytes} != {src.nbytes}")
        total = src.nbytes
        dst._invalidate(dst.offset, StrideInfo.contiguous(total))
        done = 0
        while done < total:
            c = min(_CHUNK, total - done)
            pending.push(src.store.scopy(
                src.offset + done, StrideInfo.contiguous(c),
                dst.store, dst.offset + done, StrideInfo.contiguous(c)))
            done += c
    else:
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(
                "padded-layout copies need matching logical shape/dtype: "
                f"{src.shape}/{src.dtype} -> {dst.shape}/{dst.dtype}")
        m, n = src.shape
        row_bytes = n * src.itemsize
        per = max(1, _CHUNK // max(1, row_bytes))
        # one conservative invalidate for the whole destination span
        # (write_block invalidates its own range on the mixed-order path)
        d_off0, d_si0 = dst.block_access(0, m, 0, n)
        dst._invalidate(d_off0, d_si0)
        for r0 in range(0, m, per):
            nr = min(per, m - r0)
            if src.order == dst.order:
                s_off, s_si = src.block_access(r0, nr, 0, n)
                d_off, d_si = dst.block_access(r0, nr, 0, n)
                pending.push(src.store.scopy(s_off, s_si,
                                              dst.store, d_off, d_si))
            else:  # layout change: gather, transpose on host, scatter
                dst.write_block(r0, src.read_block(r0, nr, 0, n))
    pending.wait_all()
    dst.store.flush()


def flash_truncate(arr: FlashArray, n_elems: int) -> FlashArray:
    """Shrink a 1-D array (reference: flash_truncate, lib_funcs.h:89-99)."""
    if len(arr.shape) != 1 or n_elems > arr.shape[0]:
        raise ValueError("can only truncate 1-D arrays downward")
    # coherence: cached tiles of the removed range must not survive the
    # truncate — a later write can re-extend the file with new bytes and
    # a retained entry would serve the deleted pre-truncate contents
    cut = arr.offset + n_elems * arr.itemsize
    span = (arr.shape[0] - n_elems) * arr.itemsize
    if span > 0:
        from .io.stride import StrideInfo
        arr._invalidate(cut, StrideInfo.contiguous(span))
    arr.store.truncate(cut)
    return FlashArray(arr.store, (n_elems,), arr.dtype, arr.order,
                      arr.offset, ctx=arr.ctx)
