"""Store interface + in-memory fake backend.

Mirrors the reference's BaseFileHandle abstraction (reference:
include/file_handles/file_handle.h:39-73): open/close + contiguous and
strided read/write, asynchronous with completion.  Completion callbacks are
replaced by Ticket futures (poll/wait), which compose better with Python and
with the pipeline's prefetch queues.

`MemStore` is the DRAM fake (reference: mem_file_handle.{h,cpp}) — the test
seam that lets every kernel run without an SSD.
"""
from __future__ import annotations

import itertools
import threading
from typing import Optional

import numpy as np

from .stride import StrideInfo

# Process-unique store ids for cache keying.  Neither fd numbers (OS
# recycles them) nor id(obj) (CPython recycles addresses after GC) are
# safe keys — a recycled identity would alias cache entries of a dead
# store onto a new one.
_store_uid_counter = itertools.count(1)
_store_uid_lock = threading.Lock()


def same_backing(a, b) -> bool:
    """True when two stores certainly share backing bytes: the same store
    object, or file stores over the same inode (two `open_store` calls on
    one path create distinct stores with distinct uids, so uid equality
    alone cannot catch an aliased src/dst — the sort/map overlap guards
    need inode-level identity)."""
    if a is b or store_uid(a) == store_uid(b):
        return True
    ida = a.file_identity()
    return ida is not None and ida == b.file_identity()


def store_uid(store) -> int:
    u = getattr(store, "uid", None)
    if u is None:
        with _store_uid_lock:  # first-touch may race across threads
            u = getattr(store, "uid", None)
            if u is None:
                u = next(_store_uid_counter)
                store.uid = u
    return u


class Ticket:
    """Completion future for one submitted access."""

    __slots__ = ("_done", "_error", "_cv", "_buf")

    def __init__(self, buf=None):
        self._done = False
        self._error: Optional[str] = None
        self._cv = threading.Condition()
        self._buf = buf  # keep source/dest buffer alive until completion

    def _complete(self, error: Optional[str] = None):
        with self._cv:
            self._done = True
            self._error = error
            self._cv.notify_all()

    def done(self) -> bool:
        with self._cv:
            return self._done

    def wait(self):
        with self._cv:
            while not self._done:
                self._cv.wait()
            if self._error:
                raise IOError(self._error)
        self._buf = None

    @staticmethod
    def completed() -> "Ticket":
        t = Ticket()
        t._done = True
        return t


class BaseStore:
    """Async byte store with strided access (BaseFileHandle analog)."""

    def size(self) -> int:
        raise NotImplementedError

    def truncate(self, nbytes: int):
        raise NotImplementedError

    def read(self, offset: int, sinfo: StrideInfo, out: np.ndarray) -> Ticket:
        """Gather `sinfo` at `offset` into contiguous uint8 `out`; async."""
        raise NotImplementedError

    def write(self, offset: int, sinfo: StrideInfo, src: np.ndarray) -> Ticket:
        """Scatter contiguous uint8 `src` to `sinfo` at `offset`; async."""
        raise NotImplementedError

    def flush(self):
        pass

    def close(self):
        pass

    def file_identity(self):
        """(st_dev, st_ino) for file-backed stores, None otherwise — the
        aliasing identity used by `same_backing` (fd numbers and uids
        both fail to identify one file opened twice)."""
        return None

    # -- sync conveniences (reference: read_sync/write_sync lib_funcs.h:63-72)
    def read_sync(self, offset: int, sinfo: StrideInfo) -> np.ndarray:
        from .native import alloc_aligned  # sector-aligned: O_DIRECT and
        out = alloc_aligned(sinfo.nbytes)  # kernel-AIO fast paths apply
        self.read(offset, sinfo, out).wait()
        return out

    def write_sync(self, offset: int, sinfo: StrideInfo, src: np.ndarray):
        self.write(offset, sinfo, src).wait()

    def scopy(self, src_offset: int, src_sinfo: StrideInfo, dst_store,
              dst_offset: int, dst_sinfo: StrideInfo) -> Ticket:
        """Strided store-to-store copy through DRAM (reference:
        FlashFileHandle::copy/scopy = read -> DRAM -> write,
        flash_file_handle.cpp:409-427, 718-727).  The gather and scatter
        layouts may differ as long as total bytes match.  The read is
        synchronous; the returned ticket is the in-flight write, so
        callers can pipeline successive chunks."""
        if src_sinfo.nbytes != dst_sinfo.nbytes:
            raise ValueError(
                f"scopy size mismatch: {src_sinfo.nbytes} != "
                f"{dst_sinfo.nbytes}")
        buf = self.read_sync(src_offset, src_sinfo)
        return dst_store.write(dst_offset, dst_sinfo, buf)


def _check_access(sinfo: StrideInfo, buf: np.ndarray):
    """Validate one access specifier.

    API contract: access specifiers must be NON-OVERLAPPING — every planner
    in this library builds strides from disjoint (ld-padded) matrix rows, so
    len_per_stride <= stride always holds by construction.  The reference
    instead *merges* overlapping strides into blocks at write time
    (flash_file_handle.cpp:508-716); we reject them here so a planner bug
    surfaces as an immediate error rather than a silent double-write with
    order-dependent contents.  (Distinct accesses may still share boundary
    *sectors* under O_DIRECT — that is handled by the native engine's
    per-file sector interval locks, bof_io.cpp.)"""
    if buf.dtype != np.uint8 or buf.ndim != 1:
        raise ValueError("store buffers must be 1-D uint8 views")
    if not buf.flags["C_CONTIGUOUS"]:
        # the native engine DMAs a contiguous span through ctypes.data; a
        # strided/reversed view would be silently corrupted (and a
        # negative stride would write past the allocation)
        raise ValueError("store buffers must be C-contiguous")
    if buf.nbytes < sinfo.nbytes:
        raise ValueError(f"buffer too small: {buf.nbytes} < {sinfo.nbytes}")
    if sinfo.len_per_stride > sinfo.stride and sinfo.n_strides > 1:
        raise ValueError(
            "overlapping strides in access specifier (len_per_stride > "
            "stride): access specs must cover disjoint byte ranges — see "
            "_check_access contract")


class MemStore(BaseStore):
    """In-DRAM store implementing the full interface (reference:
    mem_file_handle.cpp:9-145).  Completion is immediate but still returns a
    Ticket so callers exercise the async protocol."""

    def __init__(self, nbytes: int = 0):
        self._data = np.zeros(nbytes, dtype=np.uint8)
        self._lock = threading.Lock()

    def size(self) -> int:
        return self._data.nbytes

    def truncate(self, nbytes: int):
        with self._lock:
            if nbytes <= self._data.nbytes:
                self._data = self._data[:nbytes].copy()
            else:
                self._data = np.concatenate(
                    [self._data, np.zeros(nbytes - self._data.nbytes, np.uint8)])

    def _runs(self, offset: int, sinfo: StrideInfo):
        for i in range(sinfo.n_strides):
            fo = offset + i * sinfo.stride
            bo = i * sinfo.len_per_stride
            yield fo, bo, sinfo.len_per_stride

    def read(self, offset: int, sinfo: StrideInfo, out: np.ndarray) -> Ticket:
        _check_access(sinfo, out)
        with self._lock:
            end = self._data.nbytes
            for fo, bo, ln in self._runs(offset, sinfo):
                # reads past EOF zero-fill — the store contract (matches
                # the native engine's full_pread and PyIoPool)
                avail = max(0, min(ln, end - fo))
                out[bo:bo + avail] = self._data[fo:fo + avail]
                if avail < ln:
                    out[bo + avail:bo + ln] = 0
        return Ticket.completed()

    def write(self, offset: int, sinfo: StrideInfo, src: np.ndarray) -> Ticket:
        _check_access(sinfo, src)
        with self._lock:
            end = offset + sinfo.file_extent
            if end > self._data.nbytes:  # grow like a file would
                self._data = np.concatenate(
                    [self._data, np.zeros(end - self._data.nbytes, np.uint8)])
            for fo, bo, ln in self._runs(offset, sinfo):
                self._data[fo:fo + ln] = src[bo:bo + ln]
        return Ticket.completed()
