"""Streamed elementwise map and reduction over flash-resident arrays.

Re-design of the reference's map/reduce (reference: include/map_reduce.tpp
+ include/tasks/map_reduce_task.h): fixed-size blocks become scheduler
tasks; MapTask applies a function to a source block and writes the
destination block (map_reduce_task.h:11-48), ReduceTask folds a block to a
partial result that the host combines (map_reduce_task.h:49-98).  Where the
reference applies a std::function per element on OpenMP threads, the
function here runs on FlashConfig.device as torch ops on the block's
tensor (B11), called by the compute threads, so blocks from different
tasks pipeline through the device queue.

bof_tpu jits `fn` (`bof_tpu/ops/map_reduce.py:45` `_jit_elementwise`) and
caches the trace per fn object.  Here `fn` runs eagerly: there is no jit,
no cache and no tail padding, a numpy ufunc resolves to the torch function
of its name, and values `fn` captures are read on every call.

The reference throttles map concurrency with a pairwise dependency chain
(map_reduce.tpp:26-43); here the scheduler's in-flight cap and cache budget
provide the same bound without serializing.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from ..context import get_context
from ..core.flash_array import FlashArray
from ..core.task import FnTask
from ..utils import METRICS, cdiv


def _torch_fn(fn):
    """`fn` as it runs on a block's tensor: a numpy ufunc becomes
    torch.<its name> (a ufunc would turn the tensor into a numpy array on
    the host); any other callable runs as it is."""
    if isinstance(fn, np.ufunc):
        import torch
        tfn = getattr(torch, fn.__name__, None)
        if tfn is None:
            raise TypeError(
                f"bof_map fn {fn!r} has no torch equivalent "
                f"(torch.{fn.__name__} does not exist); pass a torch-based "
                "callable instead")
        return tfn
    return fn


def _on_device(dt) -> bool:
    """Map's device path takes elements of under 8 bytes, as bof_tpu's
    does; 64-bit blocks run fn on the host, exactly."""
    return np.dtype(dt).itemsize < 8


def bof_map(src: FlashArray, dst: FlashArray, fn: Callable,
            blk_elems: Optional[int] = None, ctx=None) -> None:
    """dst[i] = fn(src[i]) streamed in blocks (reference: flash::map,
    map_reduce.tpp:12-53).  For elements of under 8 bytes `fn` maps a 1-D
    torch tensor on FlashConfig.device to a same-shape torch tensor (a
    numpy ufunc resolves to torch.<name>; anything else it returns
    raises); for 64-bit elements it maps a numpy block on the host.  `fn`
    runs eagerly on every block, so values it captures are read on every
    call (bof_tpu's jit keeps the first trace's)."""
    ctx = ctx or src.ctx or get_context()
    if src.shape != dst.shape or len(src.shape) != 1:
        raise ValueError("map needs equal-shape 1-D arrays")
    from ..io.store import same_backing, store_uid
    if (same_backing(src.store, dst.store)
            and src.offset < dst.offset + dst.nbytes
            and dst.offset < src.offset + src.nbytes
            and not (store_uid(src.store) == store_uid(dst.store)
                     and src.offset == dst.offset
                     and src.itemsize == dst.itemsize)):
        # partially-overlapping src/dst would corrupt: block i's write can
        # cover block i+1's source bytes.  Exact in-place through the SAME
        # store is safe (read+write share one cache key/buffer per block);
        # through two stores on one inode it is not (two incoherent cache
        # entries), so that is rejected too (same guard family as
        # bof_sort)
        raise ValueError("map src/dst may alias only exactly in place "
                         "through the same store object; partially "
                         "overlapping ranges (or one file opened twice) "
                         "are rejected")
    n = src.shape[0]
    blk = blk_elems or ctx.config.map_blk_elems
    device_path = _on_device(src.dtype) and _on_device(dst.dtype)
    if device_path:
        import torch
        from .device import from_device, resolve_device
        dev = resolve_device(ctx.config.device)
        tfn = _torch_fn(fn)

        def apply(x):
            with METRICS.span("map.h2d"):
                t = torch.from_numpy(x).to(dev, copy=True)
            with METRICS.span("map.fn_d2h"):
                out = tfn(t)
                if not isinstance(out, torch.Tensor):
                    # e.g. a jax.numpy fn, which would take the tensor to
                    # the host through numpy (and cannot read one on the
                    # card)
                    raise TypeError(
                        f"bof_map fn returned a {type(out).__module__}."
                        f"{type(out).__name__}, not a torch.Tensor: for "
                        "elements of under 8 bytes fn maps the block's "
                        "tensor with torch ops")
                return from_device(out)
    else:
        # 64-bit blocks: apply fn to the numpy block directly, fanned out
        # over host threads (the reference MapTask's OpenMP elementwise
        # apply, map_reduce_task.h:11-48); fn must be value-wise
        def apply(x):
            from ..utils.hostpar import parallel_map_chunks
            return parallel_map_chunks(fn, x)
    sched = ctx.scheduler()

    tasks = []
    for b0 in range(0, n, blk):
        bn = min(blk, n - b0)
        soff, ssin = src.block_access(b0, bn)
        doff, dsin = dst.block_access(b0, bn)

        def run(task, soff=soff, ssin=ssin, doff=doff, dsin=dsin):
            x = task.buf(src.store, soff, ssin, src.dtype)
            out = apply(x)
            if out.dtype != dst.dtype:
                raise ValueError(
                    f"map fn returned {out.dtype} for a {dst.dtype} "
                    "destination; cast inside fn (silent buffer-assignment "
                    "casts hid truncation)")
            task.buf(dst.store, doff, dsin, dst.dtype)[:] = out
        t = FnTask(run)
        t.add_read(src.store, soff, ssin)
        t.add_write(dst.store, doff, dsin)
        tasks.append(t)
    sched.add_tasks(tasks)
    sched.wait_for(tasks)
    sched.flush_cache()


def _sum_block(x):
    """Exact within the accumulator type: integer inputs fold in their
    own 64-bit family (float64 would round int64 sums past 2^53 — the
    repo's 64-bit exactness invariant); floats fold in float64."""
    if x.dtype.kind == "u":
        return x.sum(dtype=np.uint64)
    if x.dtype.kind in "ib":
        return x.sum(dtype=np.int64)
    return x.sum(dtype=np.float64)


_REDUCERS = {
    "sum": (_sum_block, lambda a, b: a + b, None),  # typed zero at fold
    "max": (lambda x: x.max(), max, -np.inf),
    "min": (lambda x: x.min(), min, np.inf),
}


def bof_reduce(src: FlashArray, op: str = "sum",
               block_fn: Optional[Callable] = None,
               combine: Optional[Callable] = None,
               init=None, blk_elems: Optional[int] = None, ctx=None):
    """Fold a 1-D flash array to a scalar (reference: flash::reduce,
    map_reduce.tpp:55-89 — per-block ReduceTasks, host combines).  Either a
    named op ('sum'/'max'/'min') or custom (block_fn, combine, init).
    The blocks fold on the host, as in bof_tpu."""
    ctx = ctx or src.ctx or get_context()
    if len(src.shape) != 1:
        raise ValueError("reduce needs a 1-D array")
    if block_fn is None:
        block_fn, combine, init = _REDUCERS[op]
    n = src.shape[0]
    blk = blk_elems or ctx.config.map_blk_elems
    sched = ctx.scheduler()

    n_blocks = cdiv(n, blk)
    results = [None] * n_blocks
    lock = threading.Lock()
    tasks = []
    for bi, b0 in enumerate(range(0, n, blk)):
        bn = min(blk, n - b0)
        soff, ssin = src.block_access(b0, bn)

        def run(task, bi=bi, soff=soff, ssin=ssin):
            x = task.buf(src.store, soff, ssin, src.dtype)
            r = block_fn(x)
            with lock:  # (reference: omp critical combine, :84-88)
                results[bi] = r
        t = FnTask(run)
        t.add_read(src.store, soff, ssin)
        tasks.append(t)
    sched.add_tasks(tasks)
    sched.wait_for(tasks)
    acc = init
    for r in results:
        acc = r if acc is None else combine(acc, r)
    if acc is None:  # empty input with the typed-zero sentinel ('sum')
        acc = (np.uint64(0) if src.dtype.kind == "u"
               else np.int64(0) if src.dtype.kind in "ib" else 0.0)
    return acc
