"""Out-of-core GEMM: C = alpha * op(A) op(B) + beta * C, on torch.

The port of `bof_tpu/ops/gemm.py` (reference: src/blas/gemm.cpp:27-202 +
include/tasks/gemm_task.h): the reference blocks the problem into
GEMM_BLK_SIZE^3 tasks, serializes the K dimension with parent chains
(gemm.cpp:114-126), and re-reads the C block each chain step.  Here the K
accumulation lives in device memory: for each output superblock, the C
tile stays resident on the device across the whole K loop (one read iff
beta != 0, one write at the end), while A/B superblocks stream
SSD → host pin cache → device with prefetch lookahead.  The host pin cache
gives cross-superblock reuse and a device-side LRU tile cache
(`HbmCache`) gives device-side reuse when panels fit.

All 8 {order R/C} x {transa N/T} x {transb N/T} configurations are
supported without any host or device transposition: blocks are read
storage-major and kernel K1 (ops/matmul_cuda.py) absorbs the transposes.
Superblocks are zero-padded to the full block size, as in bof_tpu.

Streams: the producer (uploads) and the main thread (K1 launches) use
their thread's current stream, which is the device's default stream
unless the caller set another on both.  That one stream orders every
upload before the kernels that read it and makes the caching allocator's
reuse of a dropped tile safe.  An fp32 tile goes up straight from its
pin-cache buffer, which the producer has the cache page-lock first
(`device.is_whole`), so the upload is a DMA and leaves the stream soon;
the device LRU forgets each tile after the last step that reads it.  The
writer downloads on a copy stream of its own: the
main thread hands each finished block on with an event recorded behind
its last K1 launch (`device.Finished`), the copy stream waits on that
event alone, and the block goes down in runs of rows through the
context's page-locked ring (`device.D2HRing`), each run written into C
while the next one downloads.

Transfer modes, as in bof_tpu (FlashConfig): transfer_dtype='bfloat16'
rounds each A/B tile to bf16 on the host (half the bytes cross the link)
and K1 multiplies bf16 tiles into the fp32 accumulator; 'int8' quantizes
each tile to int8 with one max-abs scale (a quarter of the bytes) and K1
sums int8 products exactly before one rescale by alpha * s_a * s_b;
c_transfer_dtype='bfloat16' rounds each finished C block on the device,
downloads half the bytes and widens them exactly on the host.  The host
rounding is bof_tpu's engine's, bit for bit.

float64 (the reference's FP_DOUBLE_PRECISION build, bof_types.h:24-42)
runs the same pipeline with float64 tiles and accumulators, and K1's
'f64' variant (DMMA on the fp64 tensor cores) as the accumulate step;
`ops/gemm64.py:gemm64` is the same call under bof_tpu's name.  With
`FlashConfig.debug_checks` a float64 call first reads every A and B tile
once and rejects a non-finite value, as bof_tpu's `gemm64` does.
"""
from __future__ import annotations

import collections
import functools
import os
import queue
import threading
from typing import Optional

import numpy as np

from ..context import get_context
from ..core.flash_array import FlashArray
from ..core.pipeline import (join_threads, queue_items, queue_put,
                             queue_put_sentinel, run_stage)
from ..io.native import (bf16_to_f32, cast_bf16, quantize_i8,
                         quantize_i8_with_amax)
from ..utils import LOG, METRICS, cdiv
from . import device as dev


class HbmCache:
    """Budget-bounded LRU cache of device-resident tiles (new capability —
    the reference has no device tier).  Keys match the host tile cache; a
    value is a tensor, or (int8 tensor, scale) in the int8 transfer mode,
    charged the bytes it holds on the device."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._used = 0
        self._map = collections.OrderedDict()  # key -> (dev_tensor, nbytes)

    def get(self, key):
        hit = self._map.get(key)
        if hit is None:
            return None
        self._map.move_to_end(key)
        METRICS.add("hbm.hit")
        return hit[0]

    def peek(self, key) -> bool:
        """Residency probe with NO side effects: the producer's pin-time
        lookahead must not count a hit (the real get at use time does) or
        LRU-promote a tile `depth` steps before its use over tiles needed
        sooner."""
        return key in self._map

    def put(self, key, arr, nbytes: int):
        while self._used + nbytes > self.budget and self._map:
            # drop the reference only — consumers queued in the pipeline
            # may still hold the tensor, and kernels already queued on the
            # stream are ordered before any reuse of its memory
            _, (_old, nb) = self._map.popitem(last=False)
            self._used -= nb
        self._map[key] = (arr, nbytes)
        self._used += nbytes
        METRICS.add("hbm.miss")
        return arr

    def drop(self, key):
        """Forget `key`'s tile, which no later step reads; a consumer
        queued in the pipeline keeps its own reference."""
        hit = self._map.pop(key, None)
        if hit is not None:
            self._used -= hit[1]

    def clear(self):
        self._map.clear()
        self._used = 0


def _op_block_reader(arr: FlashArray, trans: bool):
    """Returns (access_fn, km_flag): access_fn(i, l, bi, bl) gives the
    ((offset, StrideInfo), storage_shape) of the (i, l) superblock of
    op(arr); km_flag says the storage buffer is laid out (k, m)-major
    relative to the op's logical (m, k) block."""
    if not trans:
        def access(i0, l0, bi, bl):
            # i0/l0 are *element* offsets into op(arr)'s (m, k) space
            return (arr.block_access(i0, bi, l0, bl),
                    arr._block_shape_storage(bi, bl))
        km = arr.order == "C"
    else:
        def access(i0, l0, bi, bl):
            return (arr.block_access(l0, bl, i0, bi),
                    arr._block_shape_storage(bl, bi))
        km = arr.order == "R"
    return access, km


def _storage_shape(arr: FlashArray, logical_shape):
    r, c = logical_shape
    return (r, c) if arr.order == "R" else (c, r)


def _write_rows_async(c: FlashArray, i0: int, j0: int, bi: int, bj: int,
                      r: int, host: np.ndarray):
    """Write storage rows [r, r + len(host)) of the C block at logical
    (i0, j0), real extent bi x bj, into C, whose storage rows are logical
    rows in row-major C and logical columns in column-major C; a
    tile-major C takes whole padded rows of its tile.  Returns the
    write's ticket."""
    if getattr(c, "tile", None) is not None:
        return c.write_tile_rows_async(i0, j0, r, host)
    if c.order == "R":
        return c.write_block_storage_async(i0 + r, j0, len(host), bj, host)
    return c.write_block_storage_async(i0, j0 + r, bi, len(host), host)


def _journal_header(m, n, k, alpha, beta, transa, transb, sb, dtype,
                    xfer_mode) -> str:
    """Identical to bof_tpu's header, so a journal names the same problem
    in both packages."""
    import json
    return json.dumps(
        {"m": m, "n": n, "k": k, "alpha": float(alpha),
         "beta": float(beta), "ta": transa, "tb": transb, "blk": sb,
         "dtype": str(dtype), "xfer": xfer_mode}, sort_keys=True)


def _load_journal(path: str, header: str) -> set:
    """Completed (i, j) C-superblocks recorded by an interrupted run.
    A header mismatch means the journal belongs to a DIFFERENT problem
    (shape/blk/precision changed between runs) — resuming from it would
    silently skip wrong blocks, so that is an error, not a restart."""
    done = set()
    if not os.path.exists(path):
        return done
    with open(path) as f:
        first = f.readline().rstrip("\n")
        if first != header:
            raise ValueError(
                f"resume journal {path} was written by a different gemm "
                "call (shape/blk/config mismatch); delete it to start "
                "fresh")
        for line in f:
            parts = line.split()
            # a torn final line is ignored — and a tear can truncate a
            # TOKEN, not just drop one ('12 34\n' -> '12 3' still splits
            # into two parts), so only a complete line (trailing newline
            # intact) may mark a superblock done
            if line.endswith("\n") and len(parts) == 2:
                done.add((int(parts[0]), int(parts[1])))
    return done


def _check_slice(cfg, dtype) -> None:
    """Refuse, as bof_tpu does, a transfer mode on operands that are not
    float32, and what this port does not carry: operands other than float32
    and float64."""
    xfer = cfg.transfer_dtype
    if xfer in ("bfloat16", "int8") and dtype != np.float32:
        raise ValueError(f"{xfer} transfer mode needs float32 operands")
    if cfg.c_transfer_dtype == "bfloat16" and dtype != np.float32:
        raise ValueError("bfloat16 C transfer mode needs float32 C")
    if dtype not in (np.float32, np.float64):
        raise NotImplementedError(f"gemm on {dtype} operands: the port "
                                  "carries float32 and float64")


def _check_finite(arr: FlashArray, access, outer: int, inner: int, sb: int,
                  cache) -> None:
    """debug_checks on float64: one read of every superblock of op(arr)
    ((outer, inner) its logical shape, `access` `_op_block_reader`'s)
    through the pin cache, raising ValueError at the first non-finite
    value, before anything is computed (bof_tpu's gemm64 checks in its
    amax pre-pass, ops/gemm64.py:244-252).  The pin is released on every
    path, so a retry after fixing the operand reads it afresh."""
    for o in range(cdiv(outer, sb)):
        bo = min(sb, outer - o * sb)
        for q in range(cdiv(inner, sb)):
            bq = min(sb, inner - q * sb)
            (off, sinfo), st_shape = access(o * sb, q * sb, bo, bq)
            pin = cache.pin_read(arr.store, off, sinfo)
            try:
                cache.wait_ready(pin)
                tile = cache.buf(pin).view(arr.dtype).reshape(st_shape)
                if not np.isfinite(tile).all():
                    raise ValueError(
                        f"gemm: non-finite value in operand block "
                        f"({o * sb},{q * sb}) with debug_checks on")
            finally:
                cache.unpin(pin)


# ---- the per-step stages of `gemm` and `parallel.mesh.gemm_sharded`

def pad_to(mat: np.ndarray, full_shape) -> np.ndarray:
    """`mat` zero-padded at its ends to `full_shape`."""
    if mat.shape == full_shape:
        return mat
    out = np.zeros(full_shape, mat.dtype)
    out[:mat.shape[0], :mat.shape[1]] = mat
    return out


def tile_extent(sb: int, m: int, n: int, k: int, i: int, j: int, l: int):
    """(bi, bj, bl): the real extent of step (i, j, l)'s tiles at block
    size `sb` in an (m, n, k) product; the tiles are padded to sb."""
    return min(sb, m - i * sb), min(sb, n - j * sb), min(sb, k - l * sb)


def link_round(host: np.ndarray, mode: str, amax=None):
    """(array, scale): a tile (or a rank's shard of it, quantized with the
    whole tile's max `amax`) rounded for the link in the transfer mode
    `mode`: bf16 bits, int8 with one max-abs scale, or as it is.  The
    rounding functions are looked up in this module at call time."""
    if mode == "bfloat16":
        return cast_bf16(host), None
    if mode == "int8":
        if amax is None:
            return quantize_i8(host)
        return quantize_i8_with_amax(host, amax)
    return host, None


def link_upload(host: np.ndarray, device, bf16: bool = False):
    """A rounded tile to the device; `bf16`: it holds bf16 bits."""
    return (dev.to_device_bf16(host, device) if bf16
            else dev.to_device(host, device))


class BlockAccumulator:
    """A C block's (or a rank's shard's) device accumulator over its K
    loop: `start(c_init)` (C on the device, scaled by beta in place; None
    when beta == 0), `accum` a step through the caller's `step(c, a, b,
    alpha)`, or int8's `step_q(c, a_q, b_q, alpha * s_a * s_b)`, and
    `finish`.  float64 adds beta * C in `finish`, after the K loop, as
    bof_tpu's gemm64 does; fp32 starts from it, as its accum_step does."""

    def __init__(self, shape, device, dtype, alpha: float, beta: float,
                 step, step_q=None):
        self.shape, self.device, self.dtype = shape, device, dtype
        self.alpha = alpha
        # alpha and beta in C's dtype, as bof_tpu passes them
        self.alpha_s = float(np.dtype(dtype).type(alpha))
        self.beta_s = float(np.dtype(dtype).type(beta))
        self.late_beta = np.dtype(dtype) == np.float64
        self.step, self.step_q = step, step_q

    def start(self, c_init):
        if c_init is None:
            return dev.zeros_block(self.shape, self.device, self.dtype)
        c0 = dev.scale_init(c_init, self.beta_s)
        if not self.late_beta:
            return c0
        return dev.zeros_block(self.shape, self.device, self.dtype), c0

    def accum(self, c_dev, a_dev, b_dev):
        if isinstance(c_dev, tuple):  # (the K loop's sum, beta * C)
            return self.accum(c_dev[0], a_dev, b_dev), c_dev[1]
        if self.step_q is not None:
            (a_q, sa), (b_q, sb) = a_dev, b_dev
            return self.step_q(c_dev, a_q, b_q,
                               float(np.float32(self.alpha * sa * sb)))
        return self.step(c_dev, a_dev, b_dev, self.alpha_s)

    def finish(self, c_dev):
        return c_dev[0].add_(c_dev[1]) if isinstance(c_dev, tuple) else c_dev


def _superblock_pipeline(steps, kB: int, depth: int, produce, start, accum,
                         write_all, name: str) -> None:
    """The threaded pipeline of both out-of-core gemms (`gemm` here and
    `parallel.mesh.gemm_sharded`), each plugging in its own stages:

    - a producer thread runs `produce(put)`: it reads, rounds and uploads
      the operand tiles of `steps` ((i, j, l) superblocks) in order and
      hands `put` one (a_dev, b_dev, c_init) item a step, returning early
      once `put` returns False (another stage failed);
    - this thread keeps one device accumulator a live j: `start(c_init)`
      at l == 0, then `c = accum(c, a_dev, b_dev)` each step, handed on
      after l == kB - 1 (the K1 launches) as a `device.Finished`, which
      records an event behind the block's last launch;
    - a writer thread runs `write_all(blocks)`, downloading and writing
      each finished (i, j, Finished) as the iterator yields it.

    Every queue is bounded (`depth` items) and timed, and a failure in any
    stage reaches the others through one error list, so none can hang;
    the first error is raised here once the threads have ended.  Spans
    (METRICS.span, `name` the entry's): this thread's waits for a tile are
    `<name>.tile_wait` and its launches `<name>.accum`; the producer's
    puts, the hand-off of a finished block and the writer's gets are
    `<name>.queue_wait`."""
    tile_q: queue.Queue = queue.Queue(maxsize=depth)
    write_q: queue.Queue = queue.Queue(maxsize=max(2, depth))
    errors: list = []
    queue_wait, accum_span = name + ".queue_wait", name + ".accum"

    def producer():
        produce(lambda item: queue_put(tile_q, item, errors, queue_wait))

    def writer():
        write_all(queue_items(write_q, errors, queue_wait))

    threads = [threading.Thread(target=run_stage, args=(producer, errors,
                                                        tile_q), daemon=True),
               threading.Thread(target=run_stage, args=(writer, errors),
                                daemon=True)]
    for t in threads:
        t.start()
    c_live: dict = {}  # j -> device accumulator for the current i sweep
    tiles = queue_items(tile_q, errors, name + ".tile_wait")
    try:
        for (i, j, l) in steps:
            item = next(tiles, None)
            if item is None:
                break
            a_dev, b_dev, c_init = item
            with METRICS.span(accum_span):
                if l == 0:
                    c_live[j] = start(c_init)
                c_live[j] = accum(c_live[j], a_dev, b_dev)
            if l == kB - 1:
                # timeout-put so a dead writer can't deadlock the loop
                queue_put(write_q, (i, j, dev.Finished(c_live.pop(j))),
                          errors, queue_wait)
            if errors:
                break
    except BaseException as e:
        # a dispatch or collective failure (device OOM, launch error) must
        # land in `errors`: both helper threads key their shutdown off it —
        # the producer would otherwise spin forever holding pinned tiles
        errors.append(e)
    queue_put_sentinel(write_q, errors)
    join_threads(threads, errors)
    if errors:
        raise errors[0]


@METRICS.span("gemm")
def gemm(a: FlashArray, b: FlashArray, c: FlashArray,
         alpha: float = 1.0, beta: float = 0.0,
         transa: str = "N", transb: str = "N",
         blk: Optional[int] = None, ctx=None,
         resume_journal: Optional[str] = None) -> None:
    """C = alpha*op(A)op(B) + beta*C over flash-resident matrices.

    a: logical (m,k) if transa=='N' else (k,m)
    b: logical (k,n) if transb=='N' else (n,k)
    c: logical (m,n).  Layouts may mix freely.  float32 or float64 (K1's
    'f64' variant), all three of one dtype.

    `resume_journal` makes the kernel restartable at C-SUPERBLOCK
    granularity (beyond the reference, which restarts only at kernel
    boundaries — SURVEY §5 checkpoint/resume): each finished (i, j)
    superblock is appended to the journal only AFTER its bytes are
    fsync-durable in C, so a killed run resumes by skipping exactly the
    superblocks whose data is already on disk, and the resumed C is
    byte-identical to an uninterrupted run (the K-chain order per block
    is deterministic).  The journal is keyed by the problem header and
    removed on completion.  Requires beta == 0: an interrupted write may
    leave an unfinished block partially written, which a beta
    accumulation would then read back.
    """
    ctx = ctx or c.ctx or get_context()
    cfg = ctx.config
    sb = blk or cfg.gemm_blk_size
    ta, tb = transa.upper() == "T", transb.upper() == "T"

    m, n = c.shape
    ka = a.shape[0] if ta else a.shape[1]
    kb = b.shape[1] if tb else b.shape[0]
    if ka != kb:
        raise ValueError(f"inner dims disagree: {ka} vs {kb}")
    k = ka
    if (a.shape != ((k, m) if ta else (m, k))
            or b.shape != ((n, k) if tb else (k, n))):
        raise ValueError("operand shapes inconsistent with transposes")
    if not (a.dtype == b.dtype == c.dtype):
        raise ValueError("mixed dtypes not supported")
    from ..core.flash_array import check_output_distinct
    check_output_distinct(c, a=a, b=b)
    _check_slice(cfg, c.dtype)
    device = dev.resolve_device(cfg.device)

    # tile-major operands (core/tiled_array.py): every superblock access
    # is one contiguous run, but only when the kernel blocking matches
    # the stored tile grid
    from ..core.tiled_array import check_tile_blk
    check_tile_blk((("a", a), ("b", b), ("c", c)), sb)
    c_tiled = getattr(c, "tile", None) is not None

    mB, nB, kB = cdiv(m, sb), cdiv(n, sb), cdiv(k, sb)
    a_access, a_km = _op_block_reader(a, ta)
    b_access, b_nk = _op_block_reader(b, tb)  # storage is (n,k)-major?
    c_nm = c.order == "C"
    prec = cfg.matmul_precision
    xfer_mode = cfg.transfer_dtype
    xfer_bf16 = xfer_mode == "bfloat16"
    c_xfer_bf16 = cfg.c_transfer_dtype == "bfloat16"

    cache = ctx.pin_cache()
    if cfg.debug_checks and c.dtype == np.float64:
        _check_finite(a, a_access, m, k, sb, cache)
        _check_finite(b, b_access, k, n, sb, cache)
    hbm = HbmCache(cfg.hbm_budget)
    depth = max(1, cfg.pipeline_depth)
    sync_mode = cfg.telemetry_sync

    # Device-memory-aware group schedule: partition the j space into
    # groups whose whole B panel set (G * kB tiles) plus G live C
    # accumulators fits the budget, then sweep  jg -> i -> l -> j∈jg.
    # Within a group, every B tile crosses host->device once (resident
    # across all i), and each A(i,l) tile is fetched once per group sweep
    # and reused for all G accumulations.  Total host->device traffic ≈
    # |B| + |A| * n_groups — the analog of the reference Prioritizer's
    # minimum-bytes-to-fetch objective, applied at the device tier.  The
    # tile size stays C's in the transfer modes too, as in bof_tpu, so both
    # packages plan the same steps (and journal headers name the same
    # problem); the device LRU charges the real bytes.
    tile_bytes = sb * sb * np.dtype(c.dtype).itemsize
    spare = max(cfg.hbm_budget * 0.6 - 2 * depth * tile_bytes, tile_bytes)
    G = int(max(1, min(nB, spare // (kB * tile_bytes + tile_bytes))))
    groups = [list(range(g, min(g + G, nB))) for g in range(0, nB, G)]
    if G >= nB and (nB * kB + mB * kB) * tile_bytes <= spare:
        # whole A and B tile sets fit the budget: the j-outer order
        # transfers each tile once via the LRU and spreads C write-backs
        # evenly
        steps = [(i, j, l) for j in range(nB) for i in range(mB)
                 for l in range(kB)]
    else:
        steps = [(i, j, l) for jg in groups for i in range(mB)
                 for l in range(kB) for j in jg]

    journal_f = None
    if resume_journal is not None:
        if beta != 0.0:
            raise ValueError(
                "resume_journal requires beta == 0 (an interrupted write "
                "can leave an unfinished C block partially written, which "
                "a beta accumulation would read back)")
        header = _journal_header(m, n, k, alpha, beta, transa, transb,
                                 sb, c.dtype, cfg.transfer_dtype)
        done_blocks = _load_journal(resume_journal, header)
        if done_blocks:
            steps = [s for s in steps
                     if (s[0], s[1]) not in done_blocks]
            LOG.info("gemm resume: %d of %d C superblocks already "
                     "durable, %d steps remain", len(done_blocks),
                     mB * nB, len(steps))
        journal_f = open(resume_journal, "a")
        if not done_blocks and journal_f.tell() == 0:
            journal_f.write(header + "\n")
            journal_f.flush()

    extent = functools.partial(tile_extent, sb, m, n, k)

    from ..io.store import store_uid

    def _prep(arr, access_fn, i0, l0, d0, d1):
        """Pin descriptor for one operand tile: skip the host pin (and its
        possible disk read) entirely when the tile is already
        device-resident — pinning first would re-read from disk just to
        throw it away."""
        (off, sinfo), st_shape = access_fn(i0, l0, d0, d1)
        hkey = (store_uid(arr.store), off, sinfo)
        # side-effect-free probe: hit counting + the LRU touch happen at
        # use time (get_dev), not pin-lookahead time
        if hbm.peek(hkey):
            return ("hbm", hkey, arr.store, off, sinfo, st_shape)
        pin = cache.pin_read(arr.store, off, sinfo)
        return ("pin", hkey, arr.store, off, sinfo, st_shape, pin)

    def pin_pair(idx):
        i, j, l = steps[idx]
        bi, bj, bl = extent(i, j, l)
        return (_prep(a, a_access, i * sb, l * sb, bi, bl),
                _prep(b, b_access, l * sb, j * sb, bl, bj))

    def step_keys(i, j, l):
        bi, bj, bl = extent(i, j, l)
        return [(store_uid(arr.store),) + fn(r0, c0, d0, d1)[0]
                for arr, fn, r0, c0, d0, d1 in (
                    (a, a_access, i * sb, l * sb, bi, bl),
                    (b, b_access, l * sb, j * sb, bl, bj))]

    # the last step that reads each operand tile: the producer drops the
    # tile from the device LRU there, so the call holds on the device only
    # tiles it reads again while finished C blocks wait for the writer
    last_read = {key: idx for idx, step in enumerate(steps)
                 for key in step_keys(*step)}

    def _unpin(desc):
        if desc[0] == "pin":
            cache.unpin(desc[6])

    def upload(host: np.ndarray, bf16: bool = False):
        """Host -> device copy (`bf16`: of bf16 bits); with telemetry_sync
        the device is drained inside the window so the rate sample is a
        transfer rate."""
        with METRICS.span("gemm.h2d") as sp:
            arr = link_upload(host, device, bf16)
            if sync_mode:
                dev.sync(arr)
            sp.nbytes = arr.nbytes
        if sync_mode:
            METRICS.observe("gemm.h2d_tile_gbps",
                            arr.nbytes / max(sp.seconds, 1e-9) / 1e9)
        return arr

    c_full_storage = (sb, sb)

    # ---- the superblock pipeline (_superblock_pipeline) ----------------
    # producer: disk->host (cache pins) -> host->device, with the device
    #   LRU for reuse; main thread: K1; writer: D2H -> async disk write

    def produce(put):
        pinned = collections.deque()
        try:
            for idx in range(min(depth, len(steps))):
                pinned.append(pin_pair(idx))

            def get_dev(desc):
                kind, hkey, store, off, sinfo, st_shape = desc[:6]
                hit = hbm.get(hkey)
                if hit is not None:
                    return hit
                if kind == "hbm":
                    # device-resident at pin time but evicted since: pin
                    # now.  This LOCAL pin must be released on EVERY path —
                    # the caller's finally unpins the original 'hbm'
                    # descriptor, which records no pin
                    pin = cache.pin_read(store, off, sinfo)
                    desc = ("pin", hkey, store, off, sinfo, st_shape, pin)
                try:
                    return _load(desc, hkey, st_shape)
                finally:
                    if kind == "hbm":
                        cache.unpin(desc[6])

            def _load(desc, hkey, st_shape):
                pin = desc[6]
                with METRICS.span("gemm.disk_wait"):
                    cache.wait_ready(pin)
                with METRICS.span("gemm.prep"):
                    buf = cache.buf(pin)
                    host, scale = link_round(
                        buf.view(a.dtype).reshape(st_shape), xfer_mode)
                    padded = pad_to(host, (sb, sb))
                if dev.is_whole(padded, buf):
                    cache.lock(pin)  # the upload then reads it by DMA
                # to_device returns only once the pinned buffer has been
                # read, so the caller may unpin right after
                arr = upload(padded, bf16=xfer_bf16)
                value = arr if scale is None else (arr, scale)
                return hbm.put(hkey, value, arr.nbytes)

            for idx, (i, j, l) in enumerate(steps):
                bi, bj, bl = extent(i, j, l)
                c_init = None
                if l == 0 and beta != 0.0:
                    # read+pad only: the upload is gemm.h2d
                    with METRICS.span("gemm.c_read"):
                        c_host = c.read_block_storage(i * sb, bi, j * sb,
                                                      bj)
                        c_pad = pad_to(c_host, c_full_storage)
                    c_init = upload(c_pad)
                da, db = pinned.popleft()
                try:
                    if idx + depth < len(steps):
                        pinned.append(pin_pair(idx + depth))
                    a_dev = get_dev(da)
                    b_dev = get_dev(db)
                    for desc in (da, db):
                        if last_read[desc[1]] == idx:
                            hbm.drop(desc[1])
                finally:
                    _unpin(da)  # release current-step pins even on error
                    _unpin(db)
                # a timeout-put: a dead consumer can't block us holding
                # pins forever
                if not put((a_dev, b_dev, c_init)):
                    return
        finally:
            for da, db in pinned:  # release lookahead pins on any exit
                _unpin(da)
                _unpin(db)

    # K1's steps, looked up in ops/device.py at each call
    def step(c_dev, a_dev, b_dev, alpha_s):
        return dev.accum_step(c_dev, a_dev, b_dev, alpha_s, a_km=a_km,
                              b_nk=b_nk, c_nm=c_nm, prec=prec)

    def step_q(c_dev, a_q, b_q, scale):
        return dev.accum_step_q(c_dev, a_q, b_q, scale, a_km=a_km,
                                b_nk=b_nk, c_nm=c_nm)

    acc = BlockAccumulator(c_full_storage, device, c.dtype, alpha, beta,
                           step, step_q if xfer_mode == "int8" else None)

    def finish(c_dev):
        """A finished block as it goes down (the ring's copy stream), in
        bf16 with c_transfer_dtype='bfloat16': half the bytes cross."""
        c_dev = acc.finish(c_dev)
        return dev.to_bf16(c_dev) if c_xfer_bf16 else c_dev

    def write_all(blocks):
        from ..core.pipeline import TicketWindow
        write_tickets = TicketWindow(depth=8, span="gemm.write_wait")
        ring = ctx.d2h_ring(device)
        for i, j, fin in blocks:
            bi, bj, _ = extent(i, j, 0)
            # tile-major C stores the full padded tile — hand whole rows
            # of it over instead of slicing the logical tail
            lines, width = ((sb, sb) if c_tiled
                            else _storage_shape(c, (bi, bj)))
            tickets = []

            def write_run(r, host):
                """Storage rows [r, r + len(host)) of block (i, j) into C:
                a copy where C is in DRAM, a submitted write to a file."""
                if c_xfer_bf16:  # widen back (exactly) for fp32 storage
                    host = bf16_to_f32(host)
                with METRICS.span("gemm.write", host.nbytes):
                    t = _write_rows_async(c, i * sb, j * sb, bi, bj, r, host)
                tickets.append(t)
                return t

            d2h_s = ring.download(fin, finish, lines, width, write_run,
                                  "gemm")
            if sync_mode:
                METRICS.observe("gemm.d2h_tile_gbps",
                                lines * width * (2 if c_xfer_bf16 else
                                                 c.itemsize)
                                / max(d2h_s, 1e-9) / 1e9)
            if journal_f is None:
                write_tickets.extend(tickets)
            else:
                # durability order is the journal's correctness: the
                # block's bytes reach disk (wait + fsync) BEFORE its
                # journal line does — a crash between the two re-does
                # the block, never skips a missing one
                with METRICS.span("gemm.write_wait"):
                    for t in tickets:
                        t.wait()
                    c.store.flush()
                journal_f.write(f"{i} {j}\n")
                journal_f.flush()
                os.fsync(journal_f.fileno())
        # with the waits inside push() when the window was full, so
        # disk-bound write stalls are not under-reported
        write_tickets.wait_all()

    try:
        _superblock_pipeline(steps, kB, depth, produce, acc.start,
                             acc.accum, write_all, "gemm")
    except BaseException:
        if journal_f is not None:
            journal_f.close()  # keep the journal: the next call resumes
        raise
    c.store.flush()
    if journal_f is not None:
        # complete: the journal has served its purpose (leaving it would
        # make a LATER run over rewritten operands silently skip blocks)
        journal_f.close()
        try:
            os.unlink(resume_journal)
        except OSError:
            pass
    hbm.clear()


def gemm_in_mem(a_np: np.ndarray, b_np: np.ndarray,
                c_np: Optional[np.ndarray] = None,
                alpha: float = 1.0, beta: float = 0.0,
                transa: str = "N", transb: str = "N",
                prec: str = "highest", *, device: str = "cuda") -> np.ndarray:
    """In-memory golden twin (reference: drivers/in_mem_gemm.cpp — the MKL
    twin every out-of-core kernel is differentially tested against): one
    torch matmul on `device`, the card unless the caller asks for the CPU
    (without a usable card, 'cuda' raises).  `prec` takes bof_tpu's values
    (an unknown one raises ValueError): 'highest' and 'high' are full fp32;
    'default' on the card is one TF32 pass (the operands truncated to TF32,
    their products summed in fp32); on the CPU every tier is full fp32.
    The process's TF32 switch (torch.backends.cuda.matmul.allow_tf32, which
    every thread shares) is read, never set: with it on, a full-fp32 tier
    multiplies in float64 on the card instead."""
    import torch

    from .matmul_cuda import _passes, tf32_truncate
    passes = _passes(prec)
    dvc = dev.resolve_device(device)
    a = torch.from_numpy(np.ascontiguousarray(a_np)).to(dvc)
    b = torch.from_numpy(np.ascontiguousarray(b_np)).to(dvc)
    opa = a.T if transa.upper() == "T" else a
    opb = b.T if transb.upper() == "T" else b
    if dvc.type == "cuda" and a.dtype == torch.float32:
        if passes == 1:
            opa, opb = tf32_truncate(opa), tf32_truncate(opb)
        elif torch.backends.cuda.matmul.allow_tf32:
            opa, opb = opa.double(), opb.double()
    out = alpha * (opa @ opb)
    if beta != 0.0 and c_np is not None:
        out = out + beta * torch.from_numpy(
            np.ascontiguousarray(c_np)).to(dvc)
    return out.cpu().numpy().astype(a_np.dtype)
