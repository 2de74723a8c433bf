"""Native pinned tile cache bindings + per-store routing.

`NativeTileCache` wraps the C++ cache in native/bof_cache.inc: pin/ready/
buf/unpin over sector-aligned native buffers, with misses submitted
directly to the C++ I/O engine — the reference's Program Cache read path
(cache.cpp get_buf/alloc/evict) entirely in native code.  Python borrows
buffers as zero-copy numpy views whose GC releases a borrow count, so
eviction can never free memory a consumer still references.

On a CUDA device the cache is handed the runtime's page-lock functions
(`ops/device.py:host_lock_fns`).  A caller about to upload a buffer whole
asks `lock(key)` first: the buffer is then page-locked once, for its life
in the cache, and every upload from it is a DMA the copy engine reads
directly.  A buffer is unlocked before it is freed, or handed still locked
to the miss whose eviction released it when that miss wants its size.
Locking that fails leaves the buffer pageable and is counted
(`stats()["lock_fails"]`); it never raises.  Without the functions (a CPU
device) `lock` is a no-op.

`PinRouter` presents the pin API over mixed stores: NativeFileStore
accesses go native; MemStore/PyFileStore accesses fall back to the Python
TileCache.  Keys are opaque to callers (PrefetchSeq, kernel pipelines).
"""
from __future__ import annotations

import ctypes
import time
import weakref
from typing import Optional

import numpy as np

from ..utils import METRICS
from .native import NativeFileStore, load_library
from .stride import StrideInfo


def _bind(lib):
    if getattr(lib, "_cache_bound", False):
        return lib
    lib.bof_cache_create.argtypes = [ctypes.c_longlong]
    lib.bof_cache_create.restype = ctypes.c_longlong
    lib.bof_cache_destroy.argtypes = [ctypes.c_longlong]
    lib.bof_cache_pin_read.argtypes = [ctypes.c_longlong] * 7
    lib.bof_cache_pin_read.restype = ctypes.c_longlong
    lib.bof_cache_ready.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.bof_cache_buf.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.bof_cache_buf.restype = ctypes.c_void_p
    lib.bof_cache_borrow.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.bof_cache_return.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.bof_cache_unpin.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.bof_cache_stats.argtypes = [ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_longlong)]
    lib.bof_cache_invalidate.argtypes = [ctypes.c_longlong] * 4
    lib.bof_cache_set_lock_fns.argtypes = [ctypes.c_longlong] + \
        [ctypes.c_void_p] * 3
    lib.bof_cache_lock.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_int]
    lib._cache_bound = True
    return lib


_STATS = ("used", "hits", "misses", "evictions", "entries", "read_bytes",
          "locks", "lock_bytes", "lock_ns", "lock_fails", "unlocks",
          "recycles")


class NativeTileCache:
    def __init__(self, budget_bytes: int, lock_fns=None):
        """`lock_fns`: the addresses of cudaHostRegister,
        cudaHostUnregister and cudaGetLastError (`host_lock_fns`), or
        None to keep every buffer pageable."""
        lib = load_library()
        if lib is None:
            raise RuntimeError("native engine unavailable")
        self._lib = _bind(lib)
        self._budget = int(budget_bytes)
        self._h = self._lib.bof_cache_create(budget_bytes)
        if lock_fns is not None:
            self._lib.bof_cache_set_lock_fns(self._h, *lock_fns)

    def pin_read(self, store: NativeFileStore, offset: int,
                 sinfo: StrideInfo) -> int:
        if sinfo.nbytes > self._budget:
            # same failure semantics as the Python TileCache: the native
            # side would evict everything and still overcommit unboundedly
            raise MemoryError(
                f"pinned tile ({sinfo.nbytes} B) exceeds program budget "
                f"({self._budget} B); raise program_budget or shrink the "
                f"block size")
        eid = self._lib.bof_cache_pin_read(
            self._h, store.uid, store._fd, offset, sinfo.stride,
            sinfo.n_strides, sinfo.len_per_stride)
        if eid < 0:
            raise IOError(f"native cache pin failed: errno {-eid}")
        return int(eid)

    def ready(self, key: int) -> bool:
        r = self._lib.bof_cache_ready(self._h, key)
        if r < 0:
            raise IOError(f"native cache io error: errno {-r}")
        return r == 1

    def buf_sized(self, key: int, nbytes: int) -> np.ndarray:
        self._lib.bof_cache_borrow(self._h, key)
        addr = self._lib.bof_cache_buf(self._h, key)
        if not addr:
            self._lib.bof_cache_return(self._h, key)
            raise IOError("native cache buffer missing")
        cbuf = (ctypes.c_char * nbytes).from_address(addr)
        arr = np.frombuffer(cbuf, dtype=np.uint8)
        weakref.finalize(cbuf, self._lib.bof_cache_return, self._h, key)
        return arr

    def unpin(self, key: int):
        self._lib.bof_cache_unpin(self._h, key)

    def lock(self, key: int, nbytes: int) -> bool:
        """Page-lock pinned entry `key`'s buffer (of `nbytes`), which the
        caller is about to upload whole; True if it is page-locked.  The
        registration itself runs in the span `pin_cache.lock`."""
        r = self._lib.bof_cache_lock(self._h, key, 0)
        if r == 2:
            with METRICS.span("pin_cache.lock", nbytes):
                r = self._lib.bof_cache_lock(self._h, key, 1)
        return r == 1

    def wait_ready(self, key: int, pump: bool = True):
        while not self.ready(key):
            time.sleep(0.0002)

    def invalidate(self, uid: int, lo: int, hi: int) -> int:
        """Drop unpinned cached tiles of store `uid` overlapping file
        bytes [lo, hi) — the coherence hook for direct writes that bypass
        the cache (FlashArray.write_*)."""
        r = self._lib.bof_cache_invalidate(self._h, uid, lo, hi)
        if r < 0:
            raise IOError(f"native cache invalidate failed: errno {-r}")
        return int(r)

    def stats(self) -> dict:
        """Bytes held, hits, misses, evictions and entries; `read_bytes`:
        the bytes of every pin that missed and was read; `locks`,
        `lock_bytes`, `lock_s`: the registrations made, their bytes and
        seconds; `lock_fails` (left pageable), `unlocks` (before a free)
        and `recycles` (a miss given an evicted locked buffer)."""
        s = (ctypes.c_longlong * len(_STATS))()
        self._lib.bof_cache_stats(self._h, s)
        out = dict(zip(_STATS, s))
        out["lock_s"] = out.pop("lock_ns") / 1e9
        return out

    def close(self):
        if self._h:
            # borrows are released by view GC (zero-copy numpy views hold
            # a borrow count); collect first so legitimately-dead views in
            # reference cycles return theirs and only REAL leaks trip the
            # destroy-time "live borrows" warning
            import gc
            gc.collect()
            self._lib.bof_cache_destroy(self._h)
            self._h = 0


class PinRouter:
    """Pin API over mixed store types: native stores use the C++ cache,
    everything else the Python TileCache.  Keys are tagged tuples."""

    def __init__(self, py_cache, native: Optional[NativeTileCache]):
        self._py = py_cache
        self._nat = native

    def pin_read(self, store, offset, sinfo):
        if self._nat is not None and isinstance(store, NativeFileStore):
            eid = self._nat.pin_read(store, offset, sinfo)
            return ("__nat__", eid, sinfo.nbytes)
        return ("__py__", self._py.pin_read(store, offset, sinfo))

    def ready(self, key) -> bool:
        if key[0] == "__nat__":
            return self._nat.ready(key[1])
        return self._py.ready(key[1])

    def buf(self, key) -> np.ndarray:
        if key[0] == "__nat__":
            return self._nat.buf_sized(key[1], key[2])
        return self._py.buf(key[1])

    def unpin(self, key):
        if key[0] == "__nat__":
            self._nat.unpin(key[1])
        else:
            self._py.unpin(key[1])

    def lock(self, key) -> bool:
        """Page-lock the buffer of pin `key` before an upload reads it
        whole (`NativeTileCache.lock`); the Python TileCache's stay
        pageable."""
        if key[0] == "__nat__":
            return self._nat.lock(key[1], key[2])
        return False

    def wait_ready(self, key, pump: bool = True):
        if key[0] == "__nat__":
            self._nat.wait_ready(key[1])
        else:
            self._py.wait_ready(key[1], pump=pump)
