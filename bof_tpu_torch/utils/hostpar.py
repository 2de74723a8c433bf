"""One-off host thread fan-out for Python phase bodies (bof_tpu's
`utils/hostpar.py`, the port's own copy).

The reference runs its host-side kernel bodies on OpenMP threads — the
elementwise map apply (reference: include/tasks/map_reduce_task.h:11-48)
and block sorts via __gnu_parallel::sort (include/tasks/sort_task.h:8,37).
The native engine gives the C++ bodies the same via prep_parallel
(native/bof_io.cpp); this module is the Python-side twin for bodies that
stay in numpy.  Threads work here because numpy ufuncs/sorts release the
GIL for large arrays.

Same discipline as prep_parallel: a one-off spawn, never the I/O worker
pool (phase bodies must not queue behind in-flight disk ops).  On a
single-core host this degrades to the serial call; BOF_HOST_THREADS
forces a count so the sharded paths stay covered by tests on 1-core CI.
"""
from __future__ import annotations

import os
import threading
from typing import Callable

import numpy as np


def fanout_threads(n: int, min_per: int = 1 << 19) -> int:
    """Thread count for an n-element body: hardware cores capped at 8,
    at least min_per elements each, BOF_HOST_THREADS override (<= 16)."""
    env = os.environ.get("BOF_HOST_THREADS")
    if env:
        # explicit override: the min_per amortization floor does NOT
        # apply — 1-core CI sets this to force the sharded paths under
        # test, and capping by n // min_per would silently send those
        # tests down the serial path (only the hard one-element-per-
        # shard bound remains)
        return max(1, min(int(env), 16, n))
    nt = min(os.cpu_count() or 1, 8)
    return max(1, min(nt, n // min_per if n >= min_per else 1))


def parallel_sort(x: np.ndarray) -> None:
    """In-place parallel sort of a 1-D array — the reference's
    __gnu_parallel::sort role (include/tasks/sort_task.h:8,37), built the
    fast way for this stack: shard the array over Python threads each
    running numpy's SIMD np.sort (releases the GIL; measured ~20x faster
    per shard than scalar std::sort), then one native parallel pass of
    pairwise run merges (io/native.merge_sorted_runs).  Single-core
    hosts (fanout_threads == 1) take the plain np.sort path."""
    n = len(x)
    nt = fanout_threads(n)
    if nt <= 1 or not x.flags["C_CONTIGUOUS"]:
        x.sort()
        return
    from ..io.native import _SORT_KINDS, load_library
    if load_library() is None or x.dtype not in _SORT_KINDS:
        x.sort()
        return
    bounds = np.array([i * n // nt for i in range(nt + 1)], np.int64)
    errs: list = []

    def run(i: int):
        try:
            x[bounds[i]:bounds[i + 1]].sort()
        except BaseException as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(1, nt)]
    for t in ts:
        t.start()
    run(0)
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    from ..io.native import merge_sorted_runs
    if not merge_sorted_runs(x, bounds):  # engine raced away: stay correct
        x.sort()


def parallel_map_chunks(fn: Callable, x: np.ndarray) -> np.ndarray:
    """Apply an elementwise (value-wise) fn to a 1-D array in parallel
    chunks — the reference MapTask's OpenMP elementwise apply
    (map_reduce_task.h:11-48).  fn must be value-wise: chunking changes
    the result of any fn that mixes elements (which bof_map's contract
    already forbids — the device path pads/blocks the same way).
    Exceptions from worker chunks propagate."""
    n = len(x)
    nt = fanout_threads(n)
    if nt <= 1:
        return np.asarray(fn(x))
    bounds = [i * n // nt for i in range(nt + 1)]
    outs: list = [None] * nt
    errs: list = []

    def run(i: int):
        try:
            outs[i] = np.asarray(fn(x[bounds[i]:bounds[i + 1]]))
        except BaseException as e:  # surfaced below on the caller thread
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(1, nt)]
    for t in ts:
        t.start()
    run(0)
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return np.concatenate(outs)
