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
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Optional

import numpy as np

from ..utils.hostpar import fanout_threads
from ..utils.metrics import METRICS
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


# A MemStore copy of at least SPLIT_MIN_BYTES is cut into row ranges of at
# least SPLIT_MIN_PER bytes (`fanout_threads`: 8 ranges at most), one
# copied by the calling thread and the rest by the copy pool's threads.
# `tools/torch_store_copy_premise.py` on an H100's 8-core host, writes of
# 32 KiB rows: one copy moves 4.8-6.6 GB/s from 2 MiB up; split, 16 MiB
# over 4 ranges 13.4-15.0 and 32 MiB over 8 ranges 20.6-22.8, while 8 MiB
# over 2 gains only 1.5x and 1 MiB loses to the hand-off.  Inside gemm's
# writer a 32 MiB ring slot went faster over 8 ranges than over 4, and
# than over 16 or 32 pieces handed out in turn.
SPLIT_MIN_BYTES = 16 << 20
SPLIT_MIN_PER = 4 << 20

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _copy_pool() -> ThreadPoolExecutor:
    """The copy threads, started on first use and kept for the process
    (a spawn a write costs what the split saves); at most the 16 ranges
    of fanout_threads' override, less the caller's."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(15, thread_name_prefix="store-copy")
        return _pool


def _forget_pool():
    global _pool, _pool_lock
    # a forked child has none of its parent's threads, and the lock may
    # have been held by one of them
    _pool, _pool_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


def _assign(dst: np.ndarray, src: np.ndarray, a: int, b: int):
    dst[a:b] = src[a:b]


def _copy(dst: np.ndarray, src: np.ndarray) -> bool:
    """dst[...] = src, along axis 0 (rows of a strided access, bytes of a
    contiguous one) cut over the copy pool where the copy is large; numpy
    releases the GIL in each range's copy.  A range's exception is
    raised here once every range has ended.  True where it was split."""
    n = len(dst)
    nt = (min(fanout_threads(dst.nbytes, min_per=SPLIT_MIN_PER), n)
          if dst.nbytes >= SPLIT_MIN_BYTES else 1)
    if nt <= 1:
        dst[...] = src
        return False
    cuts = [i * n // nt for i in range(nt + 1)]
    pool = _copy_pool()
    futs = [pool.submit(_assign, dst, src, cuts[i], cuts[i + 1])
            for i in range(1, nt)]
    try:
        _assign(dst, src, cuts[0], cuts[1])
    finally:
        wait(futs)
    for f in futs:
        f.result()
    return True


def _pair(data: np.ndarray, offset: int, sinfo: StrideInfo, n: int,
          buf: np.ndarray):
    """The first `n` runs of `sinfo` at `offset` in `data` and their bytes
    in contiguous `buf`: 1-D views where the access is contiguous, else
    (n, len_per_stride) views, the store's rows `stride` bytes apart."""
    ln = sinfo.len_per_stride
    if sinfo.is_contiguous():
        return data[offset:offset + n * ln], buf[:n * ln]
    rows = np.lib.stride_tricks.as_strided(
        data[offset:], shape=(n, ln), strides=(sinfo.stride, 1))
    return rows, buf[:n * ln].reshape(n, ln)


class MemStore(BaseStore):
    """In-DRAM store implementing the full interface (reference:
    mem_file_handle.cpp:9-145).  Completion is immediate but still returns a
    Ticket so callers exercise the async protocol.  An access moves its
    bytes as one strided copy, split over the copy pool when large
    (`_copy`); a split write counts `store.split_writes` and
    `store.split_bytes`."""

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

    def read(self, offset: int, sinfo: StrideInfo, out: np.ndarray) -> Ticket:
        _check_access(sinfo, out)
        n, ln = sinfo.n_strides, sinfo.len_per_stride
        with self._lock:
            end = self._data.nbytes
            # runs wholly before EOF take one copy; reads past EOF
            # zero-fill — the store contract (matches the native engine's
            # full_pread and PyIoPool): the run EOF cuts keeps its bytes
            # before it, and every later run starts past EOF
            whole = (0 if offset + ln > end else
                     min(n, (end - offset - ln) // max(sinfo.stride, 1) + 1))
            runs, buf = _pair(self._data, offset, sinfo, whole, out)
            _copy(buf, runs)
            if whole < n:
                fo, bo = offset + whole * sinfo.stride, whole * ln
                avail = max(0, min(ln, end - fo))
                out[bo:bo + avail] = self._data[fo:fo + avail]
                out[bo + avail:n * ln] = 0
        return Ticket.completed()

    def write(self, offset: int, sinfo: StrideInfo, src: np.ndarray) -> Ticket:
        _check_access(sinfo, src)
        with self._lock:
            end = offset + sinfo.file_extent
            if end > self._data.nbytes:  # grow like a file would
                self._data = np.concatenate(
                    [self._data, np.zeros(end - self._data.nbytes, np.uint8)])
            if _copy(*_pair(self._data, offset, sinfo, sinfo.n_strides,
                            src)):
                METRICS.add("store.split_writes")
                METRICS.add("store.split_bytes", sinfo.nbytes)
        return Ticket.completed()
