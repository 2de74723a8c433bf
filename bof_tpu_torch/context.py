"""Library context: backend selection, store registry, scratch allocation.

Replaces the reference's global singletons (reference: src/lib_funcs.cpp:7-33
— global Scheduler, Logger, mnt_dir scratch directory, flash_setup/
flash_destroy) with an explicit context object.  A default context is
created on demand; `flash_setup()/flash_destroy()` keep the reference's
two-call API shape.
"""
from __future__ import annotations

import atexit
import os
import tempfile
import threading
import uuid
from typing import Optional

from .config import DEFAULT_CONFIG, FlashConfig
from .io.pystore import PyFileStore, PyIoPool
from .io.store import BaseStore
from .utils import LOG


class FlashContext:
    def __init__(self, config: Optional[FlashConfig] = None):
        self.config = config or DEFAULT_CONFIG
        os.makedirs(self.config.scratch_dir, exist_ok=True)
        self._py_pool: Optional[PyIoPool] = None
        self._lock = threading.Lock()
        self._backend = self._resolve_backend()
        if self._backend == "native":
            from .io.native import apply_engine_config
            apply_engine_config(self.config)
        self._scheduler = None
        self._pin_router = None
        self._d2h_ring = None
        self._scratch_files: set[str] = set()

    def _resolve_backend(self) -> str:
        want = self.config.io_backend
        if want == "python":
            return "python"
        from .io import native
        if native.load_library() is not None:
            return "native"
        if want == "native":
            raise RuntimeError("native io backend requested but unavailable")
        return "python"

    @property
    def backend(self) -> str:
        return self._backend

    def py_pool(self) -> PyIoPool:
        with self._lock:
            if self._py_pool is None:
                self._py_pool = PyIoPool(self.config.n_io_threads)
            return self._py_pool

    def open_store(self, path: str, create: bool = False,
                   truncate_to: int = 0,
                   o_direct: Optional[bool] = None) -> BaseStore:
        od = self.config.use_o_direct if o_direct is None else o_direct
        if self._backend == "native":
            from .io.native import NativeFileStore
            return NativeFileStore(
                path, create=create, truncate_to=truncate_to, o_direct=od,
                n_threads=self.config.n_io_threads,
                max_chunk_bytes=self.config.max_chunk_bytes)
        if od:
            from .utils import LOG
            LOG.warning("use_o_direct requested but the python io backend "
                        "is active: %s opens page-cache-buffered (measured "
                        "throughput will NOT reflect O_DIRECT + kernel "
                        "AIO)", path)
        return PyFileStore(path, self.py_pool(), create=create,
                           truncate_to=truncate_to,
                           max_chunk_bytes=self.config.max_chunk_bytes)

    def scratch_store(self, nbytes: int) -> BaseStore:
        """Temp-file store under scratch_dir (reference: flash_malloc,
        lib_funcs.h:103-120)."""
        path = os.path.join(self.config.scratch_dir,
                            f"bof_scratch_{uuid.uuid4().hex}.bin")
        st = self.open_store(path, create=True, truncate_to=nbytes)
        self._scratch_files.add(path)
        return st

    def free_scratch(self, store: BaseStore):
        """Unlink a scratch store (reference: flash_free, lib_funcs.h:122-128)."""
        path = getattr(store, "path", None)
        with self._lock:
            sched = self._scheduler
        if sched is not None:
            from .io.store import store_uid
            sched.cache.forget_store(store_uid(store))
        store.close()
        if path and path in self._scratch_files:
            self._scratch_files.discard(path)
            try:
                os.unlink(path)
            except OSError:
                pass

    def scheduler(self):
        with self._lock:
            if self._scheduler is None:
                from .core.scheduler import Scheduler
                self._scheduler = Scheduler(self)
            return self._scheduler

    def coherence_invalidate(self, store, offset: int, sinfo) -> None:
        """Drop cached tiles overlapping a direct write (called by every
        FlashArray write method).  The caches retain clean tiles across
        kernel calls for reuse — unlike the reference, which flushes the
        whole Program Cache at each kernel boundary (cache.cpp:45-70) —
        so a store write that bypasses them must invalidate the stale
        range.  Never *creates* the caches: nothing to invalidate if no
        kernel has run."""
        with self._lock:
            sched = self._scheduler
            router = self._pin_router
        if sched is not None:
            sched.cache.invalidate_overlap(store, offset, sinfo)
        if router is not None and router._nat is not None:
            from .io.native import NativeFileStore
            if isinstance(store, NativeFileStore):
                router._nat.invalidate(store.uid, offset,
                                       offset + sinfo.file_extent)

    def pin_cache(self):
        """Pin API for streaming pipelines: native C++ tile cache for
        file-backed native stores, Python TileCache for everything else
        (FlashConfig.tile_cache_backend: auto|native|python).  On a CUDA
        device the native cache page-locks the buffers uploads read whole
        (`PinRouter.lock`)."""
        sched = self.scheduler()
        with self._lock:
            if self._pin_router is None:
                from .io.native_cache import NativeTileCache, PinRouter
                backend = getattr(self.config, "tile_cache_backend", "auto")
                native = None
                if backend == "native" and self._backend != "native":
                    # consistent with io_backend='native': an explicit
                    # request must fail loudly, not silently degrade
                    raise RuntimeError(
                        "tile_cache_backend='native' requires the native "
                        f"io backend (resolved: {self._backend})")
                if backend != "python" and self._backend == "native":
                    import torch
                    from .ops.device import host_lock_fns
                    try:
                        native = NativeTileCache(
                            self.config.program_budget,
                            host_lock_fns(torch.device(self.config.device)))
                    except RuntimeError:
                        if backend == "native":
                            raise
                self._pin_router = PinRouter(sched.cache, native)
            return self._pin_router

    def d2h_ring(self, device):
        """The context's download ring for `device` (ops/device.py:
        `D2HRing`, 64 MiB of page-locked host slots on a card), made at
        its first use and kept until `destroy`."""
        if device.type == "cuda" and device.index is None:
            import torch
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            ring = self._d2h_ring
            if ring is None or ring.device != device:
                from .ops.device import D2HRing
                ring = self._d2h_ring = D2HRing(device)
            return ring

    def pin_cache_stats(self) -> Optional[dict]:
        """The native pin cache's counters (`NativeTileCache.stats()`:
        used, hits, misses, evictions, entries, read_bytes and the
        page-lock counters), or None where the context's pins take the
        Python TileCache."""
        native = self.pin_cache()._nat
        return native.stats() if native is not None else None

    def destroy(self):
        with self._lock:
            if self._pin_router is not None:
                if self._pin_router._nat is not None:
                    self._pin_router._nat.close()
                self._pin_router = None
            if self._scheduler is not None:
                self._scheduler.shutdown()
                self._scheduler = None
            if self._py_pool is not None:
                self._py_pool.close()
                self._py_pool = None
            self._d2h_ring = None
        for path in list(self._scratch_files):
            try:
                os.unlink(path)
            except OSError:
                pass
        self._scratch_files.clear()


_default_ctx: Optional[FlashContext] = None
_ctx_lock = threading.Lock()


def flash_setup(scratch_dir: Optional[str] = None,
                config: Optional[FlashConfig] = None) -> FlashContext:
    """Initialize the default context (reference: flash_setup,
    lib_funcs.cpp:18-23)."""
    global _default_ctx
    with _ctx_lock:
        if _default_ctx is not None:
            LOG.warning("flash_setup called twice; destroying old context")
            _default_ctx.destroy()
        cfg = config or DEFAULT_CONFIG
        if scratch_dir:
            cfg = cfg.replace(scratch_dir=scratch_dir)
        _default_ctx = FlashContext(cfg)
        return _default_ctx


def flash_destroy():
    """Tear down the default context (reference: flash_destroy)."""
    global _default_ctx
    with _ctx_lock:
        if _default_ctx is not None:
            _default_ctx.destroy()
            _default_ctx = None


def get_context() -> FlashContext:
    global _default_ctx
    with _ctx_lock:
        if _default_ctx is None:
            _default_ctx = FlashContext(
                DEFAULT_CONFIG.replace(scratch_dir=tempfile.mkdtemp(
                    prefix="bof_tpu_torch_")))
        return _default_ctx


atexit.register(flash_destroy)
