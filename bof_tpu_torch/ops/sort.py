"""Out-of-core sample sort.

Re-design of the reference's external-memory sample sort (reference:
include/sort.tpp:13-201 + include/tasks/sort_task.h):

  phase 1 (SampleSplit, sort.tpp:35-52): sort each block in place on disk
    and sample pivot candidates;
  host: sort samples, pick n_blks-1 pivots (sort.tpp:59-65);
  phase 2 (SampleSegment, sort.tpp:72-85): per sorted block, find bucket
    boundaries against the pivots (binary search — blocks are sorted);
  host: per-(block,bucket) fragment offsets via prefix sums
    (sort.tpp:87-131);
  phase 3 (SampleMerge, sort.tpp:134-162): gather each bucket's fragments
    from every block, sort, write contiguously to the output.

The block sorter is the host's parallel np.sort by default and, with
FlashConfig.sort_compute='device', kernel B10 (`ops/sort_cuda.py`, a
stable radix sort on FlashConfig.device; its plain version on a CPU
device), which gives jnp.sort's bits as bof_tpu's device branch does.

Like the reference, the input is sorted block-wise *in place* on disk by
phase 1.  Phases are separated by task barriers + cache flushes
(sort.tpp pattern), matching the reference's two-barrier structure.
The reference throttles phase-1 concurrency with a pairwise dependency
chain (sort.tpp:35-52); the scheduler's in-flight cap provides that bound
here without serializing.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..context import get_context
from ..core.flash_array import FlashArray
from ..core.task import FnTask
from ..utils import METRICS, cdiv, fatal


def bof_sort(src: FlashArray, dst: FlashArray, descending: bool = False,
             key=None, cmp=None, blk_elems: Optional[int] = None,
             oversample: int = 32, ctx=None) -> None:
    """`key`, if given, maps a value vector to sortable keys (the analog of
    the reference's comparator template parameter, sort.tpp `Comparator`);
    it must be order-embedding (vectorized, deterministic).  A key that
    returns a TUPLE/LIST of equal-length columns sorts lexicographically
    by position (primary key first) — the multi-field comparator case —
    via an order-preserving bytes composite (utils/lexkey.py; see its
    docstring for per-column descending and NaN placement).

    `cmp`, if given, is an ARBITRARY three-way scalar comparator
    (`cmp(a, b) < 0` iff a orders before b; must induce a strict weak
    order) — the exact analog of the reference's `flash::sort<T, Cmp>`
    template argument for comparators no vectorized key expresses.  It
    runs at Python-comparison speed (every block argsort/searchsorted
    goes element-wise through `cmp`), so prefer `key=` wherever an
    order-embedding exists; a C++ less-functor `less(a,b)` maps to
    `cmp=lambda a, b: less(b, a) - less(a, b)`.  Mutually exclusive
    with `key=`.  Ascending runs are stable — equal-comparing elements
    keep their input order (stable block argsorts, pivot-consistent
    bucketing, block-ordered fragment merges); `descending=True`
    reverses the stable ascending result."""
    ctx = ctx or src.ctx or get_context()
    if cmp is not None:
        if key is not None:
            raise ValueError("pass either key= or cmp=, not both")
        from functools import cmp_to_key
        _K = cmp_to_key(cmp)

        def key(x, _K=_K):
            out = np.empty(len(x), dtype=object)
            for i, v in enumerate(x):
                out[i] = _K(v)
            return out
    if key is not None:
        _user_key = key

        def key(x, _uk=_user_key):
            k = _uk(x)
            if isinstance(k, (tuple, list)):
                from ..utils.lexkey import lex_composite
                return lex_composite(k)
            return np.asarray(k)
    if src.shape != dst.shape or len(src.shape) != 1:
        raise ValueError("sort needs equal-shape 1-D arrays")
    if src.dtype != dst.dtype:
        raise ValueError(f"sort needs matching dtypes: src {src.dtype} "
                         f"!= dst {dst.dtype}")
    from ..io.store import same_backing
    if (same_backing(src.store, dst.store)
            and src.offset < dst.offset + dst.nbytes
            and dst.offset < src.offset + src.nbytes):
        # phase 3 reads source fragments while writing the output range:
        # an in-place/overlapping sort would consume half-written buckets
        # (the reference is out-of-place too, sort.tpp:134-162)
        raise ValueError("sort output must not overlap the input "
                         "(phase 1 sorts src blocks in place; phase 3 "
                         "streams them into dst)")
    n = src.shape[0]
    if n == 0:  # empty input: sorted output is empty (n_blks==0 would
        return  # otherwise hit np.concatenate([]) in the pivot phase)
    blk = blk_elems or ctx.config.sort_blk_elems
    sched = ctx.scheduler()
    n_blks = cdiv(n, blk)
    dt = src.dtype

    # block sorter: the host's parallel np.sort by default (the reference
    # sorts blocks on CPU via __gnu_parallel::sort, sort_task.h:8);
    # sort_compute='device' runs B10 on FlashConfig.device
    device_sort = getattr(ctx.config, "sort_compute", "host") == "device"
    if device_sort and key is None:  # the key path host-argsorts anyway —
        # warning about a device fallback that never happens would mislead
        from .sort_cuda import device_sortable
        if not device_sortable(dt):
            # B10 keys elements of under 8 bytes only: 64-bit elements
            # (and records) take the host sort, the exact path (the
            # reference's own __gnu_parallel::sort, sort_task.h:8), as
            # bof_tpu sends them back from a device that would narrow them
            from ..utils import LOG
            LOG.warning("sort_compute='device' has no device key for %s; "
                        "sorting on host", dt)
            device_sort = False
    if device_sort and key is None:
        from .device import from_device, resolve_device
        from .sort_cuda import bits_of, sort_block as b10
        dev = resolve_device(ctx.config.device)

    @METRICS.span("sort.block_sort")
    def sort_block(x):
        if key is not None:
            x[:] = x[np.argsort(key(x), kind="stable")]
        elif device_sort:
            # the block as it is: no padding (bof_tpu padded to a power of
            # two only to bound XLA's compiles, bof_tpu/ops/sort.py:121-149)
            with METRICS.span("sort.h2d"):
                t = bits_of(x).to(dev, copy=True)
            x[:] = from_device(b10(t, x.dtype)).view(x.dtype)
        else:
            # parallel block sort (the reference's __gnu_parallel::sort,
            # sort_task.h:8,37): multi-core hosts shard over np.sort
            # threads + native run merge; 1-core hosts take plain np.sort
            from ..utils.hostpar import parallel_sort
            parallel_sort(x)

    def searchsorted_keyed(x_sorted, pivots):
        if key is None:
            return np.searchsorted(x_sorted, pivots, side="right")
        return np.searchsorted(key(x_sorted), pivots, side="right")

    # Blocks are kept ascending on disk through all phases; `descending`
    # only flips bucket placement and fragment order in phase 3.

    # ---- phase 1: block sort + sample -----------------------------------
    with METRICS.span("sort.phase1"):
        samples: list = [None] * n_blks
        lock = threading.Lock()
        p1 = []
        for bi in range(n_blks):
            b0 = bi * blk
            bn = min(blk, n - b0)
            off, sinfo = src.block_access(b0, bn)

            def run(task, bi=bi, off=off, sinfo=sinfo, bn=bn):
                x = task.buf(src.store, off, sinfo, dt)
                sort_block(x)  # ascending (in key order) in place
                # per-task generator: numpy Generators are not thread-safe,
                # and compute threads run phase-1 tasks concurrently
                rng = np.random.default_rng(0xB0F + bi)
                idx = np.sort(rng.integers(0, bn, min(oversample, bn)))
                picked = x[idx]
                with lock:
                    samples[bi] = (np.asarray(key(picked)) if key is not None
                                   else picked.copy())
            t = FnTask(run)
            t.add_read(src.store, off, sinfo)
            t.add_write(src.store, off, sinfo)
            p1.append(t)
        sched.add_tasks(p1)
        sched.wait_for(p1)
        sched.flush_cache()
    METRICS.add("sort.blocks", n_blks)

    if n_blks == 1:
        data = src.read_all()
        dst.write_all(data[::-1] if descending else data)
        return

    with METRICS.span("sort.phase2"):
        # ---- host: pivots (reference sorts/shuffles samples, sort.tpp:59-65)
        all_samples = np.concatenate(samples)
        all_samples.sort()
        pick = np.linspace(0, len(all_samples) - 1, n_blks + 1)[1:-1]
        pivots = all_samples[pick.astype(np.int64)]
        n_buckets = len(pivots) + 1

        # ---- phase 2: per-block bucket boundaries ---------------------------
        counts = np.zeros((n_blks, n_buckets), dtype=np.int64)
        bounds = [None] * n_blks
        p2 = []
        for bi in range(n_blks):
            b0 = bi * blk
            bn = min(blk, n - b0)
            off, sinfo = src.block_access(b0, bn)

            def run(task, bi=bi, off=off, sinfo=sinfo, bn=bn):
                x = task.buf(src.store, off, sinfo, dt)
                # block is sorted ascending (in key space): binary search
                edge = searchsorted_keyed(x, pivots)
                b = np.concatenate([[0], edge, [bn]])
                with lock:
                    bounds[bi] = b
                    counts[bi] = np.diff(b)
            t = FnTask(run)
            t.add_read(src.store, off, sinfo)
            p2.append(t)
        sched.add_tasks(p2)
        sched.wait_for(p2)

    with METRICS.span("sort.phase3"):
        # ---- host: bucket output offsets (sort.tpp:87-131) ------------------
        bucket_sizes = counts.sum(axis=0)
        bucket_starts = np.concatenate([[0], np.cumsum(bucket_sizes)])
        if bucket_starts[-1] != n:
            fatal("sample sort bucket accounting mismatch: %d != %d",
                  bucket_starts[-1], n)

        # ---- phase 3: merge each bucket -------------------------------------
        # duplicate-heavy data can funnel most elements into one pivot bucket,
        # whose merge task would then exceed the cache budget and fail deep in
        # the scheduler; surface the limit up front with a remedy (the
        # reference's sample sort shares this failure mode, sort.tpp:87-131)
        max_bucket = int(bucket_sizes.max()) if n_buckets else 0
        cache_cap = sched.cache.max_size
        if max_bucket * src.itemsize * 2 > cache_cap:
            raise ValueError(
                f"sample sort bucket of {max_bucket} elements needs "
                f"{max_bucket * src.itemsize * 2} B in-memory (> program "
                f"budget {cache_cap}); the input is too duplicate-heavy for "
                "the sampled pivots — raise program_budget or pre-partition "
                "the input")
        p3 = []
        for kb in range(n_buckets):
            outn = int(bucket_sizes[kb])
            if descending:
                out0 = int(n - bucket_starts[kb] - outn)
            else:
                out0 = int(bucket_starts[kb])
            if outn == 0:
                continue
            frags = []
            for bi in range(n_blks):
                s, e = int(bounds[bi][kb]), int(bounds[bi][kb + 1])
                if e > s:
                    frags.append(src.block_access(bi * blk + s, e - s))
            doff, dsin = dst.block_access(out0, outn)

            def run(task, frags=tuple(frags), doff=doff, dsin=dsin, outn=outn):
                parts = [task.buf(src.store, fo, fs, dt) for fo, fs in frags]
                merged = np.concatenate(parts)
                sort_block(merged)
                if descending:
                    merged = merged[::-1]
                task.buf(dst.store, doff, dsin, dt)[:] = merged
            t = FnTask(run)
            for fo, fs in frags:
                t.add_read(src.store, fo, fs)
            t.add_write(dst.store, doff, dsin)
            p3.append(t)
        sched.add_tasks(p3)
        sched.wait_for(p3)
        sched.flush_cache()
    METRICS.add("sort.buckets", len(p3))
