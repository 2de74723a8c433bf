"""Budgeted host tile cache — the "Program Cache".

Re-design of the reference's Cache (reference: include/scheduler/cache.h,
src/scheduler/cache.cpp): a single-mutex, budget-bounded buffer cache keyed
by (store, offset, StrideInfo).  Tracks promised (`commit_size`) vs
allocated (`real_size`) bytes against the budget (cache.h:98-105), admits a
task's working set only if it fits after evicting zero-referenced entries
not needed by that task (cache.cpp:346-390), services a backlog of pending
allocations by issuing async reads (cache.cpp:432-547), and on eviction
write-backs dirty buffers asynchronously, freeing them on completion
(cache.cpp:72-113).

Differences from the reference, by design:
- completion callbacks → Ticket futures reaped in service_backlog;
- evicted-dirty buffers with writes still in flight can be *resurrected*
  by a new allocation of the same key (the reference spin-waits flush);
- buffers are sector-aligned so the native O_DIRECT engine takes its
  zero-copy path.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

import numpy as np

from ..io.native import alloc_aligned
from ..io.store import Ticket
from ..utils import LOG, METRICS
from .task import Task, TaskStatus, access_key


class _Entry:
    __slots__ = ("store", "offset", "sinfo", "buf", "refs", "dirty",
                 "alloc_only", "complete", "nbytes", "error", "poisoned",
                 "stale")

    def __init__(self, store, offset, sinfo, alloc_only: bool):
        self.store = store
        self.offset = offset
        self.sinfo = sinfo
        self.buf: Optional[np.ndarray] = None
        self.refs = 1
        self.dirty = False
        self.alloc_only = alloc_only  # write-only: no read needed
        self.complete = False         # buffer resident & contents valid
        self.nbytes = sinfo.nbytes
        self.error: Optional[BaseException] = None  # failed read
        self.poisoned = False  # a failed task's write target: contents
        #   are uninitialized/partial — never serve from cache
        self.stale = False  # a direct write overlapped this tile while
        #   it was pinned: serve the current pins (documented dual-access
        #   race window) but drop at zero refs so later accesses re-fetch


class _UidKeyedDict(dict):
    """Dict keyed by (store_uid, offset, sinfo) that maintains a live
    per-uid key count, so invalidate_overlap can answer "does this store
    have anything cached/in flight?" in O(1) instead of scanning every
    entry under the global lock on every direct write.  All cache.py
    mutation sites use plain item assignment / pop / del (never
    update/setdefault), which these overrides cover."""

    def __init__(self):
        super().__init__()
        self.uid_counts: collections.Counter = collections.Counter()

    def __setitem__(self, key, value):
        if key not in self:
            self.uid_counts[key[0]] += 1
        super().__setitem__(key, value)

    def __delitem__(self, key):
        super().__delitem__(key)  # raises KeyError before the decrement
        c = self.uid_counts[key[0]] - 1
        if c:
            self.uid_counts[key[0]] = c
        else:
            del self.uid_counts[key[0]]

    def pop(self, key, *default):
        if key in self:
            val = dict.pop(self, key)
            c = self.uid_counts[key[0]] - 1
            if c:
                self.uid_counts[key[0]] = c
            else:
                del self.uid_counts[key[0]]
            return val
        if default:
            return default[0]
        raise KeyError(key)

    def _unsupported(self, *a, **k):
        # enforce (not just document) the count invariant: these inherited
        # mutators would silently desynchronize uid_counts and break
        # invalidate_overlap's O(1) early-out — a coherence bug with no
        # error at the mutation site
        raise NotImplementedError(
            "_UidKeyedDict: use item assignment / del / pop only")

    clear = update = setdefault = popitem = _unsupported


class TileCache:
    def __init__(self, max_size: int, single_use_discard: bool = False):
        self.max_size = max_size
        self.single_use_discard = single_use_discard
        self._lock = threading.Lock()
        self._entries: Dict[tuple, _Entry] = _UidKeyedDict()
        self._zero_ref = collections.OrderedDict()  # key -> None, LRU order
        self._backlog: collections.deque = collections.deque()
        self.backlog_hwm = 0  # high-water mark: authoritative (a poll
        #   loop sampling len(_backlog) can miss entries drained between
        #   samples and under-report the pressure the budget created)
        self._inflight_reads: Dict[tuple, Ticket] = {}
        self._inflight_writes: Dict[tuple, tuple] = _UidKeyedDict()
        #   key -> (tkt, nbytes, buf)
        self._orphan_tickets: List[Ticket] = []
        self.commit_size = 0
        self.real_size = 0
        self._dirty_stores: Dict[int, object] = {}
        self.write_errors: List[BaseException] = []  # failed write-backs

    # ------------------------------------------------------------ internal
    def _task_keys(self, task: Task):
        """Unique accesses of a task with read/write classification.
        Memoized on the task — alloc_ready polls every pending task each
        scheduler round, and the access lists never change after
        admission."""
        cached = getattr(task, "_key_map", None)
        if cached is not None:
            return cached
        keys: Dict[tuple, dict] = {}
        for store, off, si in task.read_list:
            k = access_key(store, off, si)
            keys.setdefault(k, {"store": store, "offset": off, "sinfo": si,
                                "read": False, "write": False})["read"] = True
        for store, off, si in task.write_list:
            k = access_key(store, off, si)
            keys.setdefault(k, {"store": store, "offset": off, "sinfo": si,
                                "read": False, "write": False})["write"] = True
        task._key_map = keys
        return keys

    def _evict_locked(self, key: tuple):
        """Evict one zero-ref entry (reference: cache.cpp:72-113)."""
        e = self._entries.pop(key)
        self._zero_ref.pop(key, None)
        self.commit_size -= e.nbytes
        tkt = self._inflight_reads.pop(key, None)
        if tkt is not None:
            # read still in flight for an evicted entry: orphan the ticket
            # (it holds the buffer alive until completion)
            self._orphan_tickets.append(tkt)
        if e.dirty:
            from ..io.store import store_uid
            try:
                tkt = e.store.write(e.offset, e.sinfo, e.buf)
            except Exception as ex:
                # a synchronously-raising store must not corrupt the
                # accounting: record the lost write-back (flush raises)
                # and free the slot
                self.write_errors.append(
                    ex if isinstance(ex, IOError) else IOError(str(ex)))
                self.real_size -= e.nbytes if e.buf is not None else 0
                METRICS.add("cache.evict_dirty_failed")
                return
            self._inflight_writes[key] = (tkt, e.nbytes, e.buf)
            # keyed by store uid, never id()/fd — both recycle (CLAUDE.md)
            self._dirty_stores[store_uid(e.store)] = e.store
            METRICS.add("cache.evict_dirty")
            METRICS.add("cache.writeback_bytes", e.nbytes)
            # real_size stays until the write completes
        else:
            self.real_size -= e.nbytes if e.buf is not None else 0
            METRICS.add("cache.evict_clean")

    def _drop_locked(self, key: tuple, e: "_Entry"):
        """Remove a zero-ref entry WITHOUT write-back (poisoned /
        single-use-discard / rollback), orphaning any in-flight read the
        way _evict_locked does: the ticket keeps the buffer alive until
        the engine finishes, and a later re-pin of the same key gets a
        fresh entry instead of being marked complete by the stale
        ticket's reap."""
        self._entries.pop(key, None)
        self._zero_ref.pop(key, None)
        self.commit_size -= e.nbytes
        tkt = self._inflight_reads.pop(key, None)
        if tkt is not None:
            self._orphan_tickets.append(tkt)
        if e.buf is not None:
            self.real_size -= e.nbytes

    def _reap_locked(self):
        # Every completion path records I/O errors instead of raising out
        # of the reap loop — an exception here once wedged the cache with
        # the ticket stuck in _inflight_reads forever.
        for k, tkt in list(self._inflight_reads.items()):
            if tkt.done():
                err = None
                try:
                    tkt.wait()
                except IOError as ex:
                    err = ex
                e = self._entries.get(k)  # may have been evicted meanwhile
                if e is not None:
                    e.complete = True
                    e.error = err
                del self._inflight_reads[k]
        for k, (tkt, nb, _buf) in list(self._inflight_writes.items()):
            if tkt.done():
                try:
                    tkt.wait()
                except IOError as ex:
                    self.write_errors.append(ex)
                self.real_size -= nb
                del self._inflight_writes[k]
        still = []
        for t in self._orphan_tickets:
            if t.done():
                try:
                    t.wait()  # frees the native ticket slot
                except IOError as ex:
                    self.write_errors.append(ex)
            else:
                still.append(t)
        self._orphan_tickets = still

    # ------------------------------------------------------------- public
    def allocate(self, task: Task) -> bool:
        """Admit a task's working set; False if over budget even after
        eviction (reference: cache.cpp:346-390)."""
        keys = self._task_keys(task)
        with self._lock:
            needed = 0
            for k, info in keys.items():
                if k not in self._entries:
                    # resurrection from _inflight_writes re-adds the bytes
                    # to commit_size, so count them here too
                    needed += info["sinfo"].nbytes
            if self.commit_size + needed > self.max_size:
                # evict LRU zero-ref entries not needed by this task
                for zk in list(self._zero_ref.keys()):
                    if zk in keys:
                        continue
                    self._evict_locked(zk)
                    if self.commit_size + needed <= self.max_size:
                        break
                if self.commit_size + needed > self.max_size:
                    METRICS.add("cache.alloc_fail")
                    return False
            applied: List[tuple] = []  # ("ref" | "new", key) for rollback
            try:
                for k, info in keys.items():
                    e = self._entries.get(k)
                    if e is not None:
                        e.refs += 1
                        applied.append(("ref", k, e.alloc_only))
                        self._zero_ref.pop(k, None)
                        if info["write"]:
                            # dirty is only set in release() after the
                            # task's execute() succeeds — a failed task
                            # must never write back its garbage buffer
                            e.alloc_only = False
                        METRICS.add("cache.hit")
                        continue
                    if k in self._inflight_writes:
                        # resurrect an evicted-dirty tile.  The in-flight
                        # write-back must COMPLETE first: handing the
                        # buffer to a writer while the engine is still
                        # pwriting from it tears the on-disk bytes, and
                        # the new owner's own eventual write-back would
                        # race this one unordered (the reference
                        # spin-waits its flush for the same reason,
                        # cache.cpp:45-70).  Bounded: one tile write.
                        tkt, nb, buf = self._inflight_writes.pop(k)
                        try:
                            tkt.wait()
                        except Exception as ex:  # any store error: record
                            self.write_errors.append(
                                ex if isinstance(ex, IOError)
                                else IOError(str(ex)))
                        # real_size: stays counted — the buffer lives on
                        # in the resurrected entry (reap no longer sees
                        # this ticket, so it won't double-decrement)
                        e = _Entry(info["store"], info["offset"],
                                   info["sinfo"], alloc_only=False)
                        e.buf = buf
                        e.complete = True  # contents valid (write done)
                        self._entries[k] = e
                        self.commit_size += nb
                        applied.append(("new", k, None))
                        METRICS.add("cache.resurrect")
                        continue
                    alloc_only = info["write"] and not info["read"]
                    e = _Entry(info["store"], info["offset"], info["sinfo"],
                               alloc_only=alloc_only)
                    self._entries[k] = e
                    self.commit_size += e.nbytes
                    applied.append(("new", k, None))  # BEFORE a later raise
                    self._backlog.append(k)
                    self.backlog_hwm = max(self.backlog_hwm,
                                           len(self._backlog))
                    METRICS.add("cache.miss")
            except BaseException:
                # exception-atomicity: an error escaping mid-loop must not
                # leave refs taken / entries created for a task the
                # scheduler will complete WITHOUT cache.release() — those
                # tiles would be pinned and their commit bytes leaked
                # until process death
                for kind, k, prev_alloc_only in reversed(applied):
                    e = self._entries.get(k)
                    if e is None:
                        continue
                    if kind == "ref":
                        e.refs -= 1
                        # restore: the failed task's write intent must not
                        # convert another task's pending write-only tile
                        # into a (possibly unreadable) read
                        e.alloc_only = prev_alloc_only
                        if e.refs == 0:
                            self._zero_ref[k] = None
                            self._zero_ref.move_to_end(k)
                    else:
                        self._drop_locked(k, e)
                raise
            task.set_status(TaskStatus.ALLOC)
            return True

    def service_backlog(self):
        """Reap finished I/O; allocate + issue reads for backlog entries
        that fit in real memory (reference: cache.cpp:432-547)."""
        with self._lock:
            self._reap_locked()
            while self._backlog:
                k = self._backlog[0]
                e = self._entries.get(k)
                if (e is None or e.buf is not None or e.complete
                        or k in self._inflight_reads):
                    # cancelled, or a DUPLICATE backlog key: an
                    # evict-then-repin cycle can queue the same key twice,
                    # and servicing it twice would double-count real_size,
                    # orphan the first read ticket un-waited, and replace
                    # a possibly-filled buffer with uninitialized memory
                    self._backlog.popleft()
                    continue
                if self.real_size + e.nbytes > self.max_size:
                    # free real memory from zero-ref complete entries so
                    # the stream's tail can't livelock once nothing else
                    # pumps allocations (pin path has no allocate() retry)
                    for zk in list(self._zero_ref.keys()):
                        ze = self._entries.get(zk)
                        if ze is None or not ze.complete:
                            continue
                        self._evict_locked(zk)
                        if self.real_size + e.nbytes <= self.max_size:
                            break
                    if self.real_size + e.nbytes > self.max_size:
                        break
                self._backlog.popleft()
                try:
                    e.buf = alloc_aligned(e.nbytes)
                except MemoryError as ex:
                    # allocation failure must not strand the entry
                    # half-initialized (its task would wait forever)
                    e.complete = True
                    e.error = ex
                    continue
                self.real_size += e.nbytes
                if e.alloc_only:
                    e.complete = True  # no read needed (cache.cpp:497-505)
                else:
                    try:
                        self._inflight_reads[k] = e.store.read(
                            e.offset, e.sinfo, e.buf)
                        METRICS.add("cache.fetch_bytes", e.nbytes)
                    except Exception as ex:
                        # a synchronously-raising store must not leave a
                        # half-allocated entry that stalls its task forever
                        e.complete = True
                        e.error = ex
            # reap again: MemStore tickets complete synchronously
            self._reap_locked()

    def alloc_ready(self, task: Task) -> bool:
        """All of the task's buffers resident (reference: scheduler.cpp
        alloc_ready filter, :46-71).  Fills task.buffers on success; a
        failed read fails the task instead (task.error set, returns True
        so the scheduler completes it)."""
        keys = self._task_keys(task)
        with self._lock:
            for k in keys:
                e = self._entries.get(k)
                if e is None or not e.complete:
                    return False
            for k in keys:
                e = self._entries[k]
                if e.error is not None or e.poisoned:
                    task.error = e.error or RuntimeError(
                        "input tile was poisoned by a failed task")
                    task.buffers = {}
                    return True
            task.buffers = {k: self._entries[k].buf for k in keys}
            return True

    def release(self, task: Task):
        """Drop the task's references (reference: cache.cpp:392-430).
        Write entries are marked dirty here — and only here — when the
        task's execute() succeeded, so a task that failed (read error or
        compute exception) never has its uninitialized/partial buffer
        written back over valid file bytes."""
        keys = self._task_keys(task)
        task.buffers = {}
        ok = task.error is None
        with self._lock:
            for k, info in keys.items():
                e = self._entries.get(k)
                if e is None:
                    continue
                if info["write"]:
                    if ok:
                        e.dirty = True
                    else:
                        e.poisoned = True
                e.refs -= 1
                if e.refs == 0:
                    if e.poisoned or e.error is not None:
                        # drop without write-back: the buffer holds a
                        # failed task's garbage/partial output or a failed
                        # read — a later pin/allocate of the same tile
                        # must re-fetch, not hit the stale error (the
                        # native cache does the same, bof_cache.inc).
                        # If it was also dirty from an earlier success,
                        # that result is lost too (shared-buffer hazard):
                        if e.dirty:
                            LOG.error("dropping dirty tile poisoned by a "
                                      "failed task (offset %d, %d B): "
                                      "earlier result NOT persisted",
                                      e.offset, e.nbytes)
                        self._drop_locked(k, e)
                        METRICS.add("cache.drop_poisoned")
                    elif e.stale:
                        # a direct write overlapped this tile mid-pin:
                        # a dirty result still writes back (same racing
                        # order as eviction would have had), but the
                        # buffer must not be served to later kernels
                        if e.dirty:
                            self._evict_locked(k)
                        else:
                            self._drop_locked(k, e)
                        METRICS.add("cache.invalidate_deferred")
                    elif self.single_use_discard and not e.dirty:
                        self._drop_locked(k, e)
                    else:
                        self._zero_ref[k] = None
                        self._zero_ref.move_to_end(k)

    # ---------------------------------------------- pin API (pipelines)
    # Single-access get/promote path (reference: Cache::get_buf,
    # cache.cpp:148-178) used by the streaming GEMM pipeline instead of
    # whole-task allocation.
    def pin_read(self, store, offset, sinfo) -> tuple:
        """Pin one read access; returns its key.  The tile is fetched via
        the backlog; poll `ready(key)` then view with `buf(key)`."""
        from ..io.store import store_uid
        k = (store_uid(store), offset, sinfo)
        with self._lock:
            e = self._entries.get(k)
            if e is not None:
                e.refs += 1
                self._zero_ref.pop(k, None)
                METRICS.add("cache.hit")
                return k
            if k in self._inflight_writes:
                # see allocate(): the write-back must finish before the
                # buffer gets a new owner (torn/unordered writes otherwise)
                tkt, nb, buf = self._inflight_writes.pop(k)
                try:
                    tkt.wait()
                except Exception as ex:  # any store error: record — an
                    # escape here would leak real_size forever (the
                    # ticket was already popped from _inflight_writes)
                    self.write_errors.append(
                        ex if isinstance(ex, IOError) else IOError(str(ex)))
                e = _Entry(store, offset, sinfo, alloc_only=False)
                e.buf = buf
                e.complete = True
                self._entries[k] = e
                self.commit_size += nb
                if self.commit_size > self.max_size:  # rebalance budget
                    for zk in list(self._zero_ref.keys()):
                        self._evict_locked(zk)
                        if self.commit_size <= self.max_size:
                            break
                METRICS.add("cache.resurrect")
                return k
            if sinfo.nbytes > self.max_size:
                raise MemoryError(
                    f"pinned tile ({sinfo.nbytes} B) exceeds program "
                    f"budget ({self.max_size} B); raise program_budget or "
                    f"shrink the block size")
            if self.commit_size + sinfo.nbytes > self.max_size:
                for zk in list(self._zero_ref.keys()):
                    if zk == k:
                        continue
                    self._evict_locked(zk)
                    if self.commit_size + sinfo.nbytes <= self.max_size:
                        break
            e = _Entry(store, offset, sinfo, alloc_only=False)
            self._entries[k] = e
            self.commit_size += e.nbytes
            self._backlog.append(k)
            self.backlog_hwm = max(self.backlog_hwm,
                                   len(self._backlog))
            METRICS.add("cache.miss")
            return k

    def ready(self, key: tuple) -> bool:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and (e.error is not None or e.poisoned):
                # mark poisoned so unpin drops the entry: a retried pin of
                # the same tile re-fetches instead of hitting this error
                # forever (parity with bof_cache_ready's containment)
                e.poisoned = True
                err = e.error
                if err is not None:
                    raise IOError(f"tile read failed: {err}") from err
                raise IOError("tile poisoned by a failed task")
            return e is not None and e.complete

    def buf(self, key: tuple) -> np.ndarray:
        with self._lock:
            return self._entries[key].buf

    def unpin(self, key: tuple):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            e.refs -= 1
            if e.refs == 0:
                if ((e.poisoned or e.error is not None)
                        or (self.single_use_discard and not e.dirty)):
                    # poisoned/errored entries drop so a retry re-fetches;
                    # an aborted stream's still-in-flight read is orphaned
                    self._drop_locked(key, e)
                elif e.stale:
                    # direct write overlapped this tile mid-pin: dirty
                    # results still write back, but never serve the buffer
                    if e.dirty:
                        self._evict_locked(key)
                    else:
                        self._drop_locked(key, e)
                    METRICS.add("cache.invalidate_deferred")
                else:
                    self._zero_ref[key] = None
                    self._zero_ref.move_to_end(key)

    def wait_ready(self, key: tuple, pump: bool = True):
        """Block until a pinned tile arrives, pumping the backlog (for use
        outside the scheduler thread)."""
        import time
        while not self.ready(key):
            if pump:
                self.service_backlog()
            time.sleep(0.0002)

    def cached_keys(self, keys) -> set:
        """Subset of `keys` currently resident or arriving — powers the
        prioritizer's bytes-to-fetch ranking (reference:
        keep_if_in_cache, cache.cpp:549-579)."""
        with self._lock:
            return {k for k in keys if k in self._entries}

    def flush(self):
        """Write back every dirty zero-ref entry and drain all I/O
        (reference: cache.cpp:45-70)."""
        import time
        with self._lock:
            for k in list(self._zero_ref.keys()):
                self._evict_locked(k)
            # drop backlog keys whose entries were evicted/cancelled —
            # nothing will ever service them
            self._backlog = collections.deque(
                k for k in self._backlog if k in self._entries)
        while True:
            self.service_backlog()  # issue any still-live backlog reads
            with self._lock:
                busy = (self._inflight_reads or self._inflight_writes
                        or self._orphan_tickets or self._backlog)
                if not busy:
                    stores = dict(self._dirty_stores)
                    self._dirty_stores.clear()
                    break
            time.sleep(0.001)
        for st in stores.values():
            st.flush()
        with self._lock:
            errs, self.write_errors = self.write_errors, []
        if errs:
            raise IOError(
                f"{len(errs)} write-back(s) failed; data NOT fully "
                f"persisted: {errs[0]}") from errs[0]

    def forget_store(self, uid: int):
        """Drop a store from the dirty-fsync map (called by free_scratch:
        a concurrent flush must not fsync a store being closed)."""
        with self._lock:
            self._dirty_stores.pop(uid, None)

    def invalidate_overlap(self, store, offset: int, sinfo) -> None:
        """Coherence hook for direct writes that bypass the cache
        (FlashArray.write_*, lib_funcs): drop every unpinned entry of
        `store` whose file extent overlaps the written byte range, so a
        later pin/allocate re-fetches instead of serving stale data.
        The reference avoids this by flushing the whole cache at every
        kernel boundary (cache.cpp:45-70); we retain clean tiles across
        kernels for reuse, so writes must invalidate selectively.

        Overlapping DIRTY zero-ref entries are evicted (their write-back
        lands first, then the caller's write wins the overlapped bytes);
        all overlapping in-flight write-backs are waited so the direct
        write cannot be reordered under them.  Entries still pinned by a
        running kernel are left alone — writing a region under an active
        pin is the documented dual-access race (as_memmap contract)."""
        from ..io.store import store_uid
        uid = store_uid(store)
        lo = offset
        hi = offset + sinfo.file_extent
        if hi <= lo:
            return
        pending = []
        with self._lock:
            # O(1) common case: direct writes mostly target fresh output
            # stores with nothing cached — skip the full-table scan
            if (uid not in self._entries.uid_counts
                    and uid not in self._inflight_writes.uid_counts):
                return
            for k, e in list(self._entries.items()):
                if k[0] != uid:
                    continue
                elo = e.offset
                ehi = e.offset + e.sinfo.file_extent
                if ehi <= lo or elo >= hi:
                    continue
                if e.refs > 0:
                    # mark stale so release() drops it at zero refs: the
                    # incoherence must not outlive the documented
                    # dual-access race window (serving THIS pin the old
                    # bytes is the race; serving every later kernel the
                    # old bytes would be a permanent coherence hole)
                    e.stale = True
                    LOG.warning(
                        "direct write overlaps a pinned cache tile "
                        "(store %d, [%d, %d)) — racing an active kernel",
                        uid, elo, ehi)
                    continue
                if e.dirty and e.complete:
                    self._evict_locked(k)  # write-back, ticket tracked
                else:
                    self._drop_locked(k, e)
                METRICS.add("cache.invalidate")
            for k in list(self._inflight_writes.keys()):
                if k[0] != uid:
                    continue
                elo, ehi = k[1], k[1] + k[2].file_extent
                if ehi <= lo or elo >= hi:
                    continue
                pending.append((k, self._inflight_writes.pop(k)))
        for _k, (tkt, nb, _buf) in pending:
            try:
                tkt.wait()
            except Exception as ex:
                with self._lock:
                    self.write_errors.append(
                        ex if isinstance(ex, IOError) else IOError(str(ex)))
            with self._lock:
                self.real_size -= nb

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._entries)
