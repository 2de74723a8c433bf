"""ctypes bindings to the native I/O engine.

The engine is the port's own copy of the JAX package's C++ source,
`bof_tpu_torch/native/bof_io.cpp` (which #includes the pin cache
`bof_cache.inc`), byte for byte the reference's while that is frozen, so
the port reads no file of `bof_tpu`.  It is built with the reference's g++
line into `build/bof_tpu_torch/native/libbof_io-<digest>.so`, keyed by a
digest of both sources and serialized by a flock, so nothing is written
next to the sources.  `NativeFileStore`
implements the BaseStore interface on top of it, giving O_DIRECT +
multi-threaded strided I/O — the role the reference's
FlashFileHandle/IoExecutor pair plays (reference: flash_file_handle.cpp,
io_executor.cpp).

Bound: the engine and pin-cache entry points, the two host helpers of
the sparse planners (`ell_fill`, `counting_argsort_i32`), the transfer
modes' host prep (`quantize_i8`, `cast_bf16`, and `ell_fill`'s bf16 value
mode) and the host block sort's run merge (`merge_sorted_runs`, which
`utils/hostpar.parallel_sort` calls).  The engine's fp64-slicing pair
(`bof_split_f64_i8`, `bof_fold_i32_f64`) stays unbound: it served only
the Ozaki emulation that K1's fp64 variant replaces.

bfloat16 has no numpy dtype without ml_dtypes, which the port does not
use: a bf16 array here is its 16 bits as np.uint16, and
`torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)` makes it a
tensor (ops/device.py).  Each helper has a numpy fallback, for when the
engine does not build, that gives the engine's bits.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..config import SECTOR_LEN
from ..utils import LOG
from .store import BaseStore, Ticket, _check_access, store_uid
from .stride import StrideInfo

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_SRC = os.path.join(_NATIVE_DIR, "bof_io.cpp")
_INC = os.path.join(_NATIVE_DIR, "bof_cache.inc")

_lib = None
_lib_lock = threading.Lock()
_engine_started = False
_span_disable_sent = None  # last value pushed to bof_set_span_disable


def build_root() -> str:
    """Directory for everything the port compiles: `$BOF_TORCH_BUILD`, else
    `build/bof_tpu_torch` beside the package (a git-ignored path)."""
    return os.environ.get("BOF_TORCH_BUILD") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "bof_tpu_torch")


def _sync_span_flag(lib):
    """Mirror BOF_NO_SPAN_COALESCE into the engine's atomic; the ctypes
    call only fires when the value changes."""
    global _span_disable_sent
    cur = 1 if os.environ.get("BOF_NO_SPAN_COALESCE") else 0
    if cur != _span_disable_sent:
        lib.bof_set_span_disable(cur)
        _span_disable_sent = cur


def _src_digest() -> str:
    import hashlib
    h = hashlib.sha256()
    for p in (_SRC, _INC):
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build() -> str:
    # build to a temp name and atomically publish: a concurrent process
    # must never dlopen a half-written ELF.  flock serializes concurrent
    # builders (parallel pytest workers).
    import fcntl
    out_dir = os.path.join(build_root(), "native")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libbof_io-{_src_digest()}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.tmp.{os.getpid()}"
    with open(so + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if os.path.exists(so):  # another process built it meanwhile
                return so
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                   "-pthread", _SRC, "-o", tmp]
            LOG.info("building native io engine: %s", " ".join(cmd))
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
            fcntl.flock(lk, fcntl.LOCK_UN)
    return so


def load_library():
    """Load (building if needed) the native engine; returns None on failure
    so callers can fall back to the Python backend (an explicit
    io_backend='native' turns that into an error, context.py)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.CalledProcessError) as e:
            LOG.warning("native io engine unavailable (%s); using python io", e)
            return None
        lib.bof_engine_start.argtypes = [ctypes.c_int]
        lib.bof_engine_stop.argtypes = []
        lib.bof_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_longlong]
        lib.bof_open.restype = ctypes.c_longlong
        lib.bof_close.argtypes = [ctypes.c_longlong]
        lib.bof_file_size.argtypes = [ctypes.c_longlong]
        lib.bof_file_size.restype = ctypes.c_longlong
        lib.bof_truncate.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
        lib.bof_fsync.argtypes = [ctypes.c_longlong]
        lib.bof_submit.argtypes = [ctypes.c_longlong] * 5 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
        lib.bof_submit.restype = ctypes.c_longlong
        lib.bof_poll.argtypes = [ctypes.c_longlong]
        lib.bof_wait.argtypes = [ctypes.c_longlong]
        lib.bof_set_aio_depth.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bof_set_verify_writes.argtypes = [ctypes.c_int]
        lib.bof_set_span_disable.argtypes = [ctypes.c_int]
        lib.bof_ell_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.bof_ell_fill.restype = None
        lib.bof_counting_argsort_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.bof_counting_argsort_i32.restype = ctypes.c_int
        lib.bof_merge_sorted_runs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int]
        lib.bof_merge_sorted_runs.restype = ctypes.c_int
        lib.bof_quantize_i8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong]
        lib.bof_quantize_i8.restype = ctypes.c_double
        lib.bof_cast_bf16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_longlong]
        lib.bof_cast_bf16.restype = None
        _lib = lib
        return _lib


def apply_engine_config(cfg):
    """Push runtime knobs into the process-wide engine: AIO queue depth
    (reference: MAX_SIMUL_REQS/MAX_EVENTS, CMakeLists.txt:38-91, used at
    flash_file_handle.cpp:78-102) and debug write read-back verification
    (flash_file_handle.cpp:394-402)."""
    lib = load_library()
    if lib is None:
        return
    simul = int(getattr(cfg, "max_simul_reqs", 64))
    if simul > 128:
        LOG.warning("max_simul_reqs=%d clamped to 128 (engine slot "
                    "ceiling; io_setup beyond fs.aio-max-nr would "
                    "silently disable kernel AIO)", simul)
        simul = 128
    lib.bof_set_aio_depth(max(1, simul), max(256, 2 * simul))
    lib.bof_set_verify_writes(1 if getattr(cfg, "debug_checks", False) else 0)


def ensure_engine(n_threads: int):
    global _engine_started
    lib = load_library()
    if lib is None:
        return None
    with _lib_lock:
        if not _engine_started:
            lib.bof_engine_start(n_threads)
            _engine_started = True
    return lib


def alloc_aligned(nbytes: int, alignment: int = SECTOR_LEN) -> np.ndarray:
    """Sector-aligned uint8 buffer (reference: alloc_aligned,
    src/utils.cpp:13-20) so O_DIRECT transfers take the zero-copy path."""
    raw = np.empty(nbytes + alignment, dtype=np.uint8)
    off = (-raw.ctypes.data) % alignment
    return raw[off:off + nbytes]


_SORT_KINDS = {
    np.dtype(np.float32): 0, np.dtype(np.float64): 1,
    np.dtype(np.int64): 2, np.dtype(np.uint64): 3,
    np.dtype(np.int32): 4, np.dtype(np.uint32): 5,
    np.dtype(np.int16): 6, np.dtype(np.uint16): 7,
    np.dtype(np.int8): 8, np.dtype(np.uint8): 9,
}


def merge_sorted_runs(x: np.ndarray, bounds: np.ndarray) -> bool:
    """In-place parallel merge of adjacent PRE-SORTED runs of a
    contiguous 1-D array — the native half of the parallel block sort
    (utils/hostpar.parallel_sort; the reference's __gnu_parallel::sort
    role, include/tasks/sort_task.h:8,37).  The runs come from numpy's
    np.sort on Python threads.  Float NaNs order last, matching np.sort.
    Returns False when the engine or dtype can't take it — the caller
    falls back to np.sort."""
    lib = load_library()
    if lib is None or not x.flags["C_CONTIGUOUS"] or x.ndim != 1:
        return False
    kind = _SORT_KINDS.get(x.dtype)
    if kind is None:
        return False
    b = np.ascontiguousarray(bounds, np.int64)
    if b.ndim != 1 or b.size < 2 or b[0] != 0 or b[-1] != x.size \
            or (np.diff(b) < 0).any():
        raise ValueError(f"bad run bounds {b} for {x.size} elements")
    return lib.bof_merge_sorted_runs(x.ctypes.data, b.ctypes.data,
                                     b.size - 1, kind) == 0


def counting_argsort_i32(keys: np.ndarray, k: int):
    """Stable argsort of int32 keys known to lie in [0, k) — the ordering
    pass of csrcsc's phase-2 ragged merge (reference: BlockMergeTask's
    OpenMP merge, csrcsc_task.h:101-169).  Parallel counting sort:
    O(n + k) work beats comparison argsort even single-threaded.  Returns
    the int64 permutation, or None (caller falls back to np.argsort)."""
    lib = load_library()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.int32)
    out = np.empty(keys.size, np.int64)
    rc = lib.bof_counting_argsort_i32(keys.ctypes.data, keys.size,
                                      int(k), out.ctypes.data)
    return out if rc == 0 else None


def quantize_i8(src: np.ndarray):
    """(int8 array, scale): per-tile max-abs quantization for the int8
    transfer mode (bof_tpu's `quantize_i8`): q = rint(x * (1 / scale))
    clamped to +/-127, scale = max|x| / 127 in fp32 (NaN ignored by the
    max; an all-zero or empty tile gets max 1).  The engine's parallel
    kernel when it builds, else `quantize_i8_numpy`, which gives the same
    bits."""
    src = np.ascontiguousarray(src, np.float32)
    lib = load_library()
    if lib is None:
        return quantize_i8_numpy(src)
    dst = np.empty(src.shape, np.int8)
    scale = lib.bof_quantize_i8(src.ctypes.data, dst.ctypes.data, src.size)
    return dst, float(scale)


def quantize_i8_numpy(src: np.ndarray):
    """The engine's `bof_quantize_i8` in numpy, bit for bit: fp32 scale
    math, round half to even, the +/-127 clamp, and what the engine's
    lrintf makes of a NaN product (from a NaN, or an Inf times a zero
    reciprocal): the out-of-range integer, clamped to -127.  (bof_tpu's
    own numpy fallback casts those to 0 instead.)"""
    src = np.ascontiguousarray(src, np.float32)
    return quantize_i8_with_amax(src, quantize_amax(src))


def quantize_amax(src: np.ndarray) -> float:
    """max|x| of a tile (or part of one) as `quantize_i8` takes it: NaN
    ignored, 0 for an empty array."""
    return float(np.fmax.reduce(np.abs(src), axis=None, initial=0.0))


def quantize_i8_with_amax(src: np.ndarray, amax: float):
    """`quantize_i8_numpy`'s bits for a part of a tile whose whole
    max|x| (NaN ignored) is `amax`: the shard of a tile spread over
    several ranks quantizes with the tile's one scale."""
    src = np.ascontiguousarray(src, np.float32)
    amax = np.float32(amax)
    if amax == 0.0:
        amax = np.float32(1.0)
    scale = amax / np.float32(127.0)
    inv = np.float32(1.0) / scale
    with np.errstate(invalid="ignore"):
        x = src * inv
        q = np.clip(np.rint(x), -127, 127)
    q[np.isnan(x)] = -127
    return q.astype(np.int8), float(scale)


def cast_bf16(src: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (np.uint16), round to nearest even, a NaN
    kept quiet: the bf16 transfer mode's host prep (bof_tpu's
    `cast_bf16`).  The engine's parallel cast when it builds, else
    `cast_bf16_numpy` (the same bits)."""
    src = np.ascontiguousarray(src, np.float32)
    lib = load_library()
    if lib is None:
        return cast_bf16_numpy(src)
    dst = np.empty(src.shape, np.uint16)
    lib.bof_cast_bf16(src.ctypes.data, dst.ctypes.data, src.size)
    return dst


def cast_bf16_numpy(src: np.ndarray) -> np.ndarray:
    """The engine's `bof_cast_bf16` in numpy: add 0x7fff plus the kept
    bit's parity and drop the low 16 bits; a NaN keeps its top bits with
    the quiet bit set."""
    u = np.ascontiguousarray(src, np.float32).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
    quiet = (u >> 16) | np.uint32(0x0040)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits (np.uint16) -> float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def ell_fill(starts: np.ndarray, counts: np.ndarray, ja_blk: np.ndarray,
             va_blk: np.ndarray, rows_pad: int, rmax: int,
             idx_dtype, val_dtype):
    """Native padded-ELL row gather (the sparse planners' host prep);
    returns (ja_ell, va_ell) or None when the engine or this dtype
    combination is unavailable (caller falls back to the numpy chain).
    Supported: ja int64 -> int32|uint16; va f32 -> f32, f32 -> bf16 bits
    (val_dtype np.uint16: `cast_bf16`'s rounding), f64 -> f64,
    bit-identical to the numpy path."""
    lib = load_library()
    if lib is None:
        return None
    if ja_blk.dtype != np.int64 or not ja_blk.flags.c_contiguous \
            or not va_blk.flags.c_contiguous:
        return None
    idx_dtype = np.dtype(idx_dtype)
    if idx_dtype == np.int32:
        jk = 0
    elif idx_dtype == np.uint16:
        jk = 1
    else:
        return None
    vd = np.dtype(val_dtype if val_dtype is not None else va_blk.dtype)
    if va_blk.dtype == np.float32 and vd == np.float32:
        vk = 0
    elif va_blk.dtype == np.float32 and vd == np.uint16:
        vk = 1
    elif va_blk.dtype == np.float64 and vd == np.float64:
        vk = 2
    else:
        return None
    starts = np.ascontiguousarray(starts, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    ja_ell = np.empty((rows_pad, rmax), idx_dtype)
    va_ell = np.empty((rows_pad, rmax), vd)
    lib.bof_ell_fill(starts.ctypes.data, counts.ctypes.data,
                     len(counts), rows_pad, rmax, len(ja_blk),
                     ja_blk.ctypes.data, ja_ell.ctypes.data, jk,
                     va_blk.ctypes.data, va_ell.ctypes.data, vk)
    return ja_ell, va_ell


class NativeTicket(Ticket):
    __slots__ = ("_lib", "_tid", "_waiting")

    def __init__(self, lib, tid: int, buf):
        super().__init__(buf)
        self._lib = lib
        self._tid = tid
        self._waiting = False  # a thread is inside bof_wait

    def done(self) -> bool:
        """True once the access completed (with OR without error — call
        wait() to surface errors; poll never frees the ticket slot)."""
        with self._cv:
            if self._done:
                return True
            if self._waiting:
                # another thread is inside bof_wait, which FREES the
                # slot on return: polling now could read a recycled
                # ticket id — report not-done until _complete fires
                return False
        return self._lib.bof_poll(self._tid) != 0

    def wait(self):
        with self._cv:
            while self._waiting and not self._done:
                self._cv.wait()  # another thread owns the bof_wait call
            if self._done:
                if self._error:
                    raise IOError(self._error)
                return
            # exactly one thread may call bof_wait: it frees the ticket
            # slot, and slot ids are recycled — a second concurrent call
            # could block on (and free!) an unrelated ticket
            self._waiting = True
        rc = self._lib.bof_wait(self._tid)  # releases the GIL
        err = None if rc == 0 else f"native io error: errno {-rc}"
        self._complete(err)  # notifies any waiters parked above
        self._buf = None
        if err:
            raise IOError(err)


class NativeFileStore(BaseStore):
    def __init__(self, path: str, create: bool = False, truncate_to: int = 0,
                 o_direct: bool = False, n_threads: int = 8,
                 max_chunk_bytes: int = 32 << 20):
        lib = ensure_engine(n_threads)
        if lib is None:
            raise RuntimeError("native io engine unavailable")
        self._lib = lib
        fd = lib.bof_open(path.encode(), 1 if create else 0,
                          1 if o_direct else 0, truncate_to)
        if fd < 0:
            raise IOError(f"open({path}) failed: errno {-fd}")
        self._fd = fd
        self.uid = store_uid(self)
        self.path = path
        self.o_direct = o_direct
        self._max_chunk = max_chunk_bytes
        # serializes close() against flush/submit/size: a raw check-then-
        # act on self._fd would let a concurrently-closed (and OS-recycled)
        # fd reach the engine
        self._fd_lock = threading.Lock()

    def size(self) -> int:
        with self._fd_lock:
            if self._fd is None:
                raise IOError(f"store is closed: {self.path}")
            return self._lib.bof_file_size(self._fd)

    def file_identity(self):
        with self._fd_lock:
            if self._fd is None:
                return None
            st = os.fstat(self._fd)
            return (st.st_dev, st.st_ino)

    def truncate(self, nbytes: int):
        with self._fd_lock:
            if self._fd is None:
                raise IOError(f"store is closed: {self.path}")
            self._lib.bof_truncate(self._fd, nbytes)

    def _submit(self, offset: int, sinfo: StrideInfo, buf: np.ndarray,
                is_write: bool) -> Ticket:
        _check_access(sinfo, buf)
        _sync_span_flag(self._lib)
        with self._fd_lock:
            if self._fd is None:
                raise IOError(f"store is closed: {self.path}")
            tid = self._lib.bof_submit(
                self._fd, offset, sinfo.stride, sinfo.n_strides,
                sinfo.len_per_stride, buf.ctypes.data, 1 if is_write else 0,
                self._max_chunk)
        if tid < 0:
            raise IOError(f"submit failed: errno {-tid}")
        return NativeTicket(self._lib, tid, buf)

    def read(self, offset: int, sinfo: StrideInfo, out: np.ndarray) -> Ticket:
        return self._submit(offset, sinfo, out, is_write=False)

    def write(self, offset: int, sinfo: StrideInfo, src: np.ndarray) -> Ticket:
        return self._submit(offset, sinfo, src, is_write=True)

    def flush(self):
        with self._fd_lock:
            if self._fd is None:
                return  # freed/closed concurrently
            self._lib.bof_fsync(self._fd)

    def close(self):
        with self._fd_lock:
            if self._fd is not None and self._fd >= 0:
                self._lib.bof_close(self._fd)
            self._fd = None
