"""Task scheduler — the 5-stage out-of-core execution pipeline.

Re-design of the reference's Scheduler (reference: include/scheduler/
scheduler.h, src/scheduler/scheduler.cpp): a scheduler thread moves tasks
through Wait → AllocReady → Alloc(prefetch) → ComputeReady → Compute →
Complete (scheduler.cpp:73-216): (1) drain completions, record them, release
cache refs, enqueue continuations (:120-137); (2) promote waiting tasks
whose parents completed into the prioritizer (:139-164); (3) admit up to
`max_in_mem_tasks` = factor × n_compute tasks into the cache, stopping at
the first that doesn't fit (:166-184, :78); (4) move tasks whose buffers
all arrived to the compute queue (:186-198); (5) service the cache backlog
(:200-201).  A pool of compute threads executes `task.execute()`
(:218-267); JAX device work inside execute() releases the GIL, so compute
threads overlap both each other and the I/O threads.

The event-driven loop replaces the reference's 50-100 ms adaptive sleep
(:204-212) — sub-millisecond reaction at small task counts.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, List, Optional

from ..utils import LOG, METRICS, Timer
from .cache import TileCache
from .prioritizer import Prioritizer
from .task import Task, TaskStatus


class CompletionRecord:
    """Growable bitmap of completed task ids (reference: scheduler.h:20-68
    — the same structure; a Python set would cost ~100 B per task ever
    completed, real memory in a long-lived process streaming millions of
    block tasks, vs 1 bit here)."""

    def __init__(self):
        self._bits = bytearray(1024)
        self._lock = threading.Lock()

    def mark(self, task_id: int):
        with self._lock:
            byte = task_id >> 3
            if byte >= len(self._bits):
                self._bits.extend(
                    bytes(max(byte + 1 - len(self._bits), len(self._bits))))
            self._bits[byte] |= 1 << (task_id & 7)

    def _is_complete_locked(self, task_id: int) -> bool:
        byte = task_id >> 3
        return (byte < len(self._bits)
                and bool(self._bits[byte] & (1 << (task_id & 7))))

    def is_complete(self, task_id: int) -> bool:
        with self._lock:
            return self._is_complete_locked(task_id)

    def all_complete(self, ids: Iterable[int]) -> bool:
        with self._lock:
            return all(self._is_complete_locked(i) for i in ids)


class SchedulerOptions:
    """Runtime toggles (reference: SchedulerOptions, scheduler.h:70-83)."""

    def __init__(self, enable_prioritizer: bool = True,
                 single_use_discard: bool = False):
        self.enable_prioritizer = enable_prioritizer
        self.single_use_discard = single_use_discard


class Scheduler:
    def __init__(self, ctx, options: Optional[SchedulerOptions] = None):
        cfg = ctx.config
        self.options = options or SchedulerOptions(
            enable_prioritizer=cfg.enable_prioritizer,
            single_use_discard=cfg.single_use_discard)
        self.cache = TileCache(cfg.program_budget,
                               self.options.single_use_discard)
        self.prio = Prioritizer(self.cache, self.options.enable_prioritizer)
        self.c_rec = CompletionRecord()
        self._n_compute = cfg.n_compute_threads
        self._in_mem_factor = cfg.max_in_mem_tasks_factor
        self._max_in_mem = self._in_mem_factor * self._n_compute

        self._wait_tasks: List[Task] = []
        self._alloced: List[Task] = []
        self._compute_q: queue.Queue = queue.Queue()
        self._complete_q: queue.Queue = queue.Queue()
        self._in_flight = 0  # tasks admitted to cache, not yet complete

        self._failed: set[int] = set()  # ids of failed tasks (cascade)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._all_done = threading.Event()
        self._all_done.set()
        self._shutdown = False
        self._pending = 0  # tasks added, not yet complete
        self._rank_round = 0  # periodic prioritizer refresh counter

        self._sched_thread = threading.Thread(
            target=self._sched_loop, name="bof-sched", daemon=True)
        self._sched_thread.start()
        self._compute_threads: List[threading.Thread] = []
        self._pending_pills = 0  # shrink requests not yet honored
        self._thread_seq = 0
        self.set_num_compute_threads(self._n_compute)

    # ------------------------------------------------------------- public
    def add_task(self, task: Task):
        with self._lock:
            self._wait_tasks.append(task)
            self._pending += 1
            self._all_done.clear()
        self._wake.set()

    def add_tasks(self, tasks: Iterable[Task]):
        tasks = list(tasks)
        with self._lock:
            self._wait_tasks.extend(tasks)
            self._pending += len(tasks)
            if tasks:
                self._all_done.clear()
        self._wake.set()

    def wait_for(self, tasks: Iterable[Task], timeout: Optional[float] = None):
        """Barrier on specific tasks (reference: sleep_wait_for_complete,
        bof_utils.h:25-38 — 10 ms polling; here event-driven)."""
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in tasks:
            while t.get_status() != TaskStatus.COMPLETE:
                if deadline and time.monotonic() > deadline:
                    raise TimeoutError(f"task {t.id} not complete")
                time.sleep(0.0005)
            if t.error is not None:
                raise RuntimeError(f"task {t.id} failed") from t.error

    def wait_all(self):
        self._all_done.wait()

    def flush_cache(self):
        """Persist all dirty tiles (reference: Scheduler::flush_cache,
        scheduler.h:131, cache.cpp:45-70)."""
        self.cache.flush()

    def set_num_compute_threads(self, n: int):
        """Grow or shrink the compute pool (reference: scheduler.cpp
        :284-296 supports both).  Shrink is honored via poison pills:
        surplus threads exit after finishing their current task, so no
        queued or running task is ever lost."""
        n = max(1, int(n))
        with self._lock:
            effective = len(self._compute_threads) - self._pending_pills
            while effective < n:
                t = threading.Thread(
                    target=self._compute_loop,
                    name=f"bof-compute-{self._thread_seq}", daemon=True)
                self._thread_seq += 1
                t.start()
                self._compute_threads.append(t)
                effective += 1
            for _ in range(effective - n):
                self._pending_pills += 1
                self._compute_q.put(None)
            self._n_compute = n
            # keep the admission cap in step with the pool: extra threads
            # would starve behind a stale cap; a shrunk pool drains any
            # excess in-flight tasks before admitting more
            self._max_in_mem = self._in_mem_factor * n

    def shutdown(self):
        import time
        with self._lock:
            self._shutdown = True
        self._wake.set()
        for _ in self._compute_threads:
            self._compute_q.put(None)
        self._sched_thread.join(timeout=10)
        # generous join: a task inside execute() may be in a 30s+ cold
        # remote JAX compile (CLAUDE.md); draining before it finishes
        # would silently skip its release + write-back
        deadline = time.monotonic() + 60
        for t in self._compute_threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        laggards = [t for t in self._compute_threads if t.is_alive()]
        if laggards:
            LOG.error("shutdown: %d compute thread(s) still running after "
                      "60 s — their tasks' results will NOT be persisted "
                      "by this flush", len(laggards))
            # surface as a flush error too: callers checking persistence
            # (drivers, tests) must see an exception, not just a log line
            self.cache.write_errors.append(IOError(
                f"{len(laggards)} compute thread(s) outlived shutdown; "
                "their results were not persisted"))
        # drain completions the exited sched thread never saw, so their
        # cache refs drop and flush() can write their dirty tiles back
        while True:
            try:
                tsk = self._complete_q.get_nowait()
            except queue.Empty:
                break
            if tsk is not None and getattr(tsk, "_admitted", True):
                self.cache.release(tsk)
                tsk.set_status(TaskStatus.COMPLETE)
        self.cache.flush()

    # ------------------------------------------------------------ threads
    def _sched_loop(self):
        # adaptive idle backoff (reference sleeps 50-100 ms adaptively,
        # scheduler.cpp:204-212; we start at 2 ms and decay when idle)
        idle_wait = 0.002
        while True:
            woke = self._wake.wait(timeout=idle_wait)
            self._wake.clear()
            with self._lock:
                if self._shutdown:
                    return
            progressed = True
            any_progress = woke
            while progressed:
                try:
                    progressed = self._sched_round()
                except Exception:
                    # A dead scheduler thread hangs every waiter forever;
                    # log, back off, and keep scheduling (per-task errors
                    # surface through task.error / ticket waits).
                    LOG.exception("scheduler round failed; continuing")
                    METRICS.add("sched.round_errors")
                    progressed = False
                    idle_wait = 0.1
                any_progress = any_progress or progressed
            idle_wait = 0.002 if any_progress else min(idle_wait * 2, 0.1)

    def _sched_round(self) -> bool:
        progressed = False
        inserted = False
        # (1) drain completions (scheduler.cpp:120-137)
        while True:
            try:
                tsk = self._complete_q.get_nowait()
            except queue.Empty:
                break
            progressed = True
            self.c_rec.mark(tsk.id)
            if getattr(tsk, "_admitted", True):
                self.cache.release(tsk)
            if tsk.error is not None:
                self._failed.add(tsk.id)
            tsk.set_status(TaskStatus.COMPLETE)
            with self._lock:
                self._in_flight -= 1
                self._pending -= 1
                if tsk.next is not None:
                    if tsk.error is not None:
                        # failure cascades down continuation chains
                        # (the reference GLOG_FATALs instead)
                        tsk.next.error = RuntimeError(
                            f"upstream task {tsk.id} failed")
                        tsk.next._admitted = False
                        self._in_flight += 1
                        self._pending += 1
                        self._complete_q.put(tsk.next)
                    else:
                        self._wait_tasks.append(tsk.next)
                        self._pending += 1
                if self._pending == 0:
                    self._all_done.set()
            METRICS.add("sched.completed")

        # (2) Wait → Ready where all parents complete (scheduler.cpp:142-147)
        failed_children = []
        with self._lock:
            still_waiting = []
            for t in self._wait_tasks:
                if any(p in self._failed for p in t.parents):
                    # a parent failed: fail the child instead of computing
                    # over never-produced inputs
                    t.error = RuntimeError("parent task failed")
                    t._admitted = False
                    self._in_flight += 1
                    failed_children.append(t)
                    progressed = True
                elif self.c_rec.all_complete(t.parents):
                    t.set_status(TaskStatus.ALLOC_READY)
                    self.prio.insert(t)
                    inserted = True
                    progressed = True
                else:
                    still_waiting.append(t)
            self._wait_tasks = still_waiting
        for t in failed_children:
            self._complete_q.put(t)
        if inserted or (progressed and self._rank_round % 8 == 0):
            # re-rank on new inserts, plus a periodic refresh so residency
            # drift still re-orders a long-stable queue; re-sorting every
            # round (the reference's behavior) was the top profiled cost
            # of the scheduler thread at high task rates
            self.prio.update()
        if progressed:
            self._rank_round += 1

        # (3) admit tasks to cache while under the in-flight cap
        # (scheduler.cpp:166-184, max = 4*n_compute :78)
        while self._in_flight < self._max_in_mem:
            t = self.prio.get_prio()
            if t is None:
                break
            try:
                admitted = self.cache.allocate(t)
            except Exception as ex:
                # an eviction write or store error escaping allocate()
                # must fail THIS task, not strand it outside every queue
                # (wait_for would hang forever on a dropped task)
                t.error = ex
                t._admitted = False
                LOG.error("task %d: allocate failed: %s", t.id, ex)
                self._complete_q.put(t)
                with self._lock:
                    self._in_flight += 1  # balanced by completion drain
                progressed = True
                continue
            if admitted:
                with self._lock:
                    self._in_flight += 1
                    self._alloced.append(t)
                progressed = True
            elif t.size > self.cache.max_size:
                # can never fit: fail the task instead of deadlocking
                t.error = MemoryError(
                    f"task working set {t.size} B exceeds program budget "
                    f"{self.cache.max_size} B")
                t._admitted = False  # never entered the cache: no release
                LOG.error("task %d: %s", t.id, t.error)
                self._complete_q.put(t)
                with self._lock:
                    self._in_flight += 1  # balanced by completion drain
                progressed = True
            else:
                self.prio.return_prio(t)
                break

        # (5 first: issue I/O so step 4 can observe fresh completions)
        self.cache.service_backlog()

        # (4) Alloc → ComputeReady (scheduler.cpp:186-198)
        with self._lock:
            pending = self._alloced
            self._alloced = []
        for t in pending:
            if self.cache.alloc_ready(t):
                progressed = True
                if t.error is not None:  # a tile read failed: skip compute
                    self._complete_q.put(t)
                else:
                    t.set_status(TaskStatus.COMPUTE_READY)
                    self._compute_q.put(t)
            else:
                with self._lock:
                    self._alloced.append(t)
        return progressed

    def _compute_loop(self):
        while True:
            tsk = self._compute_q.get()
            if tsk is None:
                with self._lock:
                    if self._pending_pills > 0:  # pool shrink, not shutdown
                        self._pending_pills -= 1
                        me = threading.current_thread()
                        if me in self._compute_threads:
                            self._compute_threads.remove(me)
                return
            tsk.set_status(TaskStatus.COMPUTE)
            timer = Timer()
            try:
                tsk.execute()
            except Exception as e:  # pragma: no cover
                tsk.error = e
                LOG.exception("task %d failed", tsk.id)
                METRICS.add("sched.task_errors")
            METRICS.add("sched.compute_ms", timer.elapsed_ms())
            self._complete_q.put(tsk)
            self._wake.set()
