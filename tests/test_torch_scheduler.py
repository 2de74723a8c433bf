"""The port's task scheduler, Program Cache and prioritizer
(`bof_tpu_torch/core/{task,scheduler,cache,prioritizer}.py`) against
bof_tpu's, case for case after tests/test_scheduler.py: the same task DAGs
over memory and file stores run on a context of each package, and each
must leave the same bytes, finish in the same order where the DAG fixes
one, and raise the same error type where a task, a read or a write-back
fails."""
import threading
import time

import numpy as np
import pytest

from torch_pair import BOTH, run_both


@pytest.fixture
def contexts(tmp_path):
    """One context of each package, with the reference tests' settings."""
    ctxs = {pk.name: pk.context(tmp_path / pk.name) for pk in BOTH}
    yield ctxs
    for c in ctxs.values():
        c.destroy()


def fn_task(pk, run):
    return pk.mod("core.task").FnTask(run)


def stride(pk, stride, n_strides, len_per_stride):
    return pk.mod("io.stride").StrideInfo(
        stride=stride, n_strides=n_strides, len_per_stride=len_per_stride)


def rw_task(pk, run, store, off, sinfo, read=True, write=True):
    t = fn_task(pk, run)
    if read:
        t.add_read(store, off, sinfo)
    if write:
        t.add_write(store, off, sinfo)
    return t


def on_both(contexts, body):
    """(body(REF, its ctx), body(PORT, its ctx))."""
    return tuple(body(pk, contexts[pk.name]) for pk in BOTH)


def test_simple_map_task(contexts):
    """One task doubling a block in place (read and write one access)."""
    data = np.random.default_rng(0).standard_normal(1024).astype(np.float32)

    def body(pk, ctx):
        arr = pk.bt.mem_array((1024,), np.float32, data=data, ctx=ctx)
        sched = ctx.scheduler()
        off, sinfo = arr.block_access(0, 1024)

        def run(task):
            task.buf(arr.store, off, sinfo, np.float32)[:] *= 2.0
        t = rw_task(pk, run, arr.store, off, sinfo)
        sched.add_task(t)
        sched.wait_for([t])
        sched.flush_cache()
        return arr.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port, data * 2.0)
    np.testing.assert_array_equal(port, ref)


def test_dependency_chain_order(contexts):
    """Parents gate children: a chain of 8 runs in order."""
    def body(pk, ctx):
        arr = pk.bt.mem_array((128,), np.float32,
                              data=np.zeros(128, np.float32), ctx=ctx)
        sched = ctx.scheduler()
        off, sinfo = arr.block_access(0, 128)
        order, lock, tasks, prev = [], threading.Lock(), [], None
        for i in range(8):
            def run(task, i=i):
                with lock:
                    order.append(i)
                task.buf(arr.store, off, sinfo, np.float32)[:] += i + 1
            t = rw_task(pk, run, arr.store, off, sinfo)
            if prev is not None:
                t.add_parent(prev.id)
            tasks.append(t)
            prev = t
        sched.add_tasks(tasks)
        sched.wait_for(tasks)
        sched.flush_cache()
        return order, arr.read_all()
    (ref_order, ref), (order, port) = on_both(contexts, body)
    assert order == ref_order == list(range(8))
    np.testing.assert_array_equal(port, np.full(128, 36.0))
    np.testing.assert_array_equal(port, ref)


def test_continuation_chain(contexts):
    """task.next runs after its task completes."""
    def body(pk, ctx):
        arr = pk.bt.mem_array((64,), np.float32,
                              data=np.ones(64, np.float32), ctx=ctx)
        sched = ctx.scheduler()
        off, sinfo = arr.block_access(0, 64)

        def mul(task):
            task.buf(arr.store, off, sinfo, np.float32)[:] *= 3.0
        t1 = rw_task(pk, mul, arr.store, off, sinfo)
        t2 = rw_task(pk, mul, arr.store, off, sinfo)
        t1.add_next(t2)
        sched.add_task(t1)
        sched.wait_for([t1, t2])
        sched.flush_cache()
        return arr.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port, np.full(64, 9.0))
    np.testing.assert_array_equal(port, ref)


def test_budget_eviction_writeback(tmp_path):
    """A working set past a 1 MiB budget: tiles are evicted with
    write-back and re-read, and the file ends exact."""
    init = np.random.default_rng(0).standard_normal(16 * 16384).astype(
        np.float32)

    def body(pk):
        ctx = pk.context(tmp_path / pk.name / "s", program_budget=1 << 20)
        try:
            n_blocks, blk = 16, 64 * 1024 // 4
            arr = pk.bt.map_array(str(tmp_path / pk.name / "d.bin"),
                                  (n_blocks * blk,), np.float32,
                                  create=True, ctx=ctx)
            arr.write_all(init)
            sched = ctx.scheduler()
            tasks = []
            for p in range(2):  # pass 2 depends on pass 1, block by block
                for b in range(n_blocks):
                    off, sinfo = arr.block_access(b * blk, blk)

                    def run(task, off=off, sinfo=sinfo):
                        task.buf(arr.store, off, sinfo,
                                 np.float32)[:] += 1.0
                    t = rw_task(pk, run, arr.store, off, sinfo)
                    if p == 1:
                        t.add_parent(tasks[b].id)
                    tasks.append(t)
            sched.add_tasks(tasks)
            sched.wait_for(tasks, timeout=60)
            sched.flush_cache()
            assert sched.cache.commit_size <= ctx.config.program_budget
            return arr.read_all()
        finally:
            ctx.destroy()
    ref, port = run_both(body)
    np.testing.assert_array_equal(port, (init + np.float32(1.0))
                                  + np.float32(1.0))
    np.testing.assert_array_equal(port, ref)


def test_oversized_task_fails_cleanly(contexts):
    def body(pk, ctx):
        arr = pk.bt.mem_array((1,), np.float32, ctx=ctx)
        t = fn_task(pk, lambda task: None)
        t.add_read(arr.store, 0, stride(pk, 1 << 20, 512, 1 << 20))
        ctx.scheduler().add_task(t)
        with pytest.raises(RuntimeError) as e:
            ctx.scheduler().wait_for([t], timeout=30)
        return type(e.value)
    ref, port = on_both(contexts, body)
    assert port is ref


def test_failing_task_propagates(contexts):
    def body(pk, ctx):
        arr = pk.bt.mem_array((16,), np.float32, ctx=ctx)
        off, sinfo = arr.block_access(0, 16)

        def boom(task):
            raise ValueError("kaboom")
        t = rw_task(pk, boom, arr.store, off, sinfo, write=False)
        ctx.scheduler().add_task(t)
        with pytest.raises(RuntimeError) as e:
            ctx.scheduler().wait_for([t], timeout=30)
        return type(e.value)
    ref, port = on_both(contexts, body)
    assert port is ref


def test_shared_tile_reuse(contexts):
    """Tasks sharing a read tile hit the cache: 7 hits of 8 reads."""
    data = np.random.default_rng(0).standard_normal(256).astype(np.float32)

    def body(pk, ctx):
        metrics = pk.mod("utils").METRICS
        arr = pk.bt.mem_array((256,), np.float32, data=data, ctx=ctx)
        out = pk.bt.mem_array((8,), np.float32,
                              data=np.zeros(8, np.float32), ctx=ctx)
        sched = ctx.scheduler()
        off, sinfo = arr.block_access(0, 256)
        metrics.reset()
        tasks = []
        for i in range(8):
            ooff, osinfo = out.block_access(i, 1)

            def run(task, ooff=ooff, osinfo=osinfo):
                x = task.buf(arr.store, off, sinfo, np.float32)
                task.buf(out.store, ooff, osinfo, np.float32)[:] = x.sum()
            t = fn_task(pk, run)
            t.add_read(arr.store, off, sinfo)
            t.add_write(out.store, ooff, osinfo)
            tasks.append(t)
        sched.add_tasks(tasks)
        sched.wait_for(tasks)
        sched.flush_cache()
        return out.read_all(), metrics.snapshot().get("cache.hit", 0)
    (ref, ref_hits), (port, hits) = on_both(contexts, body)
    np.testing.assert_allclose(port, np.full(8, data.sum()), rtol=1e-6)
    np.testing.assert_array_equal(port, ref)
    assert hits >= 7 and ref_hits >= 7


def test_single_use_discard_option(tmp_path):
    """single_use_discard frees clean tiles at zero refs: only the tiny
    output tiles stay committed."""
    data = np.random.default_rng(0).standard_normal(4096).astype(np.float32)

    def body(pk):
        ctx = pk.context(tmp_path / pk.name, n_io_threads=2,
                         single_use_discard=True)
        try:
            arr = pk.bt.mem_array((4096,), np.float32, data=data, ctx=ctx)
            out = pk.bt.mem_array((4,), np.float32,
                                  data=np.zeros(4, np.float32), ctx=ctx)
            sched = ctx.scheduler()
            tasks = []
            for i in range(4):
                off, sinfo = arr.block_access(i * 1024, 1024)
                ooff, osin = out.block_access(i, 1)

                def run(task, off=off, sinfo=sinfo, ooff=ooff, osin=osin):
                    x = task.buf(arr.store, off, sinfo, np.float32)
                    task.buf(out.store, ooff, osin, np.float32)[:] = x.sum()
                t = fn_task(pk, run)
                t.add_read(arr.store, off, sinfo)
                t.add_write(out.store, ooff, osin)
                tasks.append(t)
            sched.add_tasks(tasks)
            sched.wait_for(tasks)
            sched.flush_cache()
            return out.read_all(), sched.cache.commit_size
        finally:
            ctx.destroy()
    (ref, ref_commit), (port, commit) = run_both(body)
    np.testing.assert_allclose(port, data.reshape(4, 1024).sum(1),
                               rtol=1e-6)
    np.testing.assert_array_equal(port, ref)
    assert commit == ref_commit and commit <= 4 * 4


def test_fcfs_prioritizer_disabled(tmp_path):
    def body(pk):
        ctx = pk.context(tmp_path / pk.name, n_io_threads=2,
                         n_compute_threads=1, enable_prioritizer=False)
        try:
            arr = pk.bt.mem_array((1000,), np.float32,
                                  data=np.arange(1000, dtype=np.float32),
                                  ctx=ctx)
            sched = ctx.scheduler()
            tasks = []
            for i in range(10):
                off, sinfo = arr.block_access(i * 100, 100)

                def run(task, off=off, sinfo=sinfo):
                    task.buf(arr.store, off, sinfo, np.float32)[:] += 1.0
                tasks.append(rw_task(pk, run, arr.store, off, sinfo))
            sched.add_tasks(tasks)
            sched.wait_for(tasks)
            sched.flush_cache()
            return arr.read_all()
        finally:
            ctx.destroy()
    ref, port = run_both(body)
    np.testing.assert_array_equal(port, np.arange(1000, dtype=np.float32)
                                  + 1.0)
    np.testing.assert_array_equal(port, ref)


def test_prioritizer_picks_the_same_order(tmp_path):
    """With one compute thread, the prioritizer's choice among ready tasks
    (the fewest bytes to fetch first, test_scheduler.py's default-on
    path) runs the same tasks in the same order in both packages."""
    def body(pk):
        ctx = pk.context(tmp_path / pk.name, n_io_threads=1,
                         n_compute_threads=1)
        try:
            arr = pk.bt.mem_array((4096,), np.float32,
                                  data=np.arange(4096, dtype=np.float32),
                                  ctx=ctx)
            sched = ctx.scheduler()
            order, lock, tasks = [], threading.Lock(), []
            gate = threading.Event()
            head = fn_task(pk, lambda task: gate.wait(10))
            for i in range(12):
                n = 128 * (1 + (i * 5) % 7)
                off, sinfo = arr.block_access((i * 300) % 3000, n)

                def run(task, i=i):
                    with lock:
                        order.append(i)
                t = rw_task(pk, run, arr.store, off, sinfo, write=False)
                t.add_parent(head.id)
                tasks.append(t)
            sched.add_tasks([head] + tasks)
            gate.set()
            sched.wait_for([head] + tasks, timeout=60)
            return order
        finally:
            ctx.destroy()
    ref, port = run_both(body)
    assert sorted(port) == list(range(12))
    assert port == ref


def test_failure_cascades_to_children_and_continuations(contexts):
    """Children of a failed parent and its continuations fail too."""
    def body(pk, ctx):
        arr = pk.bt.mem_array((16,), np.float32, ctx=ctx)
        sched = ctx.scheduler()
        off, sinfo = arr.block_access(0, 16)

        def boom(task):
            raise ValueError("boom")
        parent = rw_task(pk, boom, arr.store, off, sinfo, write=False)
        child = rw_task(pk, lambda task: None, arr.store, off, sinfo,
                        write=False)
        child.add_parent(parent.id)
        cont = rw_task(pk, lambda task: None, arr.store, off, sinfo,
                       write=False)
        parent.add_next(cont)
        sched.add_tasks([parent, child])
        raised = []
        for t in (parent, child, cont):
            with pytest.raises(RuntimeError) as e:
                sched.wait_for([t], timeout=30)
            raised.append(type(e.value))
        return raised
    ref, port = on_both(contexts, body)
    assert port == ref


def test_oversized_pin_raises(contexts):
    def body(pk, ctx):
        arr = pk.bt.mem_array((16,), np.float32, ctx=ctx)
        with pytest.raises(MemoryError) as e:
            ctx.scheduler().cache.pin_read(
                arr.store, 0, stride(pk, 1 << 20, 512, 1 << 20))
        return type(e.value)
    ref, port = on_both(contexts, body)
    assert port is ref is MemoryError


class _FailingStore:
    """A store whose reads always fail (asynchronously, on the ticket, or
    synchronously, raising)."""

    def __init__(self, pk, inner, fail_async=True):
        self._pk = pk
        self._inner = inner
        self._fail_async = fail_async

    def read(self, offset, sinfo, out):
        if not self._fail_async:
            raise IOError("synchronous read explosion")
        t = self._pk.mod("io.store").Ticket(out)
        t._complete("injected read failure")
        return t

    def write(self, offset, sinfo, src):
        return self._inner.write(offset, sinfo, src)

    def read_sync(self, offset, sinfo):
        return self._pk.mod("io.store").BaseStore.read_sync(self, offset,
                                                            sinfo)

    def flush(self):
        pass


@pytest.mark.parametrize("fail_async", [True, False])
def test_io_error_fails_task_not_hangs(contexts, fail_async):
    """A failing read surfaces through wait_for as the same error type."""
    def body(pk, ctx):
        base = pk.bt.mem_array((64,), np.float32,
                               data=np.ones(64, np.float32), ctx=ctx)
        bad = _FailingStore(pk, base.store, fail_async=fail_async)
        off, sinfo = base.block_access(0, 64)
        t = fn_task(pk, lambda task: None)
        t.add_read(bad, off, sinfo)
        ctx.scheduler().add_task(t)
        with pytest.raises(RuntimeError) as e:
            ctx.scheduler().wait_for([t], timeout=30)
        return type(e.value)
    ref, port = on_both(contexts, body)
    assert port is ref


def test_io_error_surfaces_through_pin_path(contexts):
    def body(pk, ctx):
        base = pk.bt.mem_array((64,), np.float32, ctx=ctx)
        bad = _FailingStore(pk, base.store)
        cache = ctx.scheduler().cache
        key = cache.pin_read(bad, *base.block_access(0, 64))
        with pytest.raises(IOError) as e:
            cache.wait_ready(key, pump=True)
        cache.unpin(key)
        return type(e.value)
    ref, port = on_both(contexts, body)
    assert port is ref


def test_failed_read_task_does_not_corrupt_store_on_flush(contexts):
    """A read+write task whose read fails does not flush its unwritten
    buffer over the valid bytes."""
    def body(pk, ctx):
        good = pk.bt.mem_array((64,), np.float32,
                               data=np.arange(64, dtype=np.float32), ctx=ctx)
        bad_base = pk.bt.mem_array((64,), np.float32, ctx=ctx)
        bad = _FailingStore(pk, bad_base.store)
        sched = ctx.scheduler()
        t = fn_task(pk, lambda task: None)
        t.add_read(bad, *bad_base.block_access(0, 64))
        t.add_write(good.store, *good.block_access(0, 64))
        sched.add_task(t)
        with pytest.raises(RuntimeError):
            sched.wait_for([t], timeout=30)
        sched.flush_cache()
        return good.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port, np.arange(64, dtype=np.float32))
    np.testing.assert_array_equal(port, ref)


def test_failed_execute_does_not_corrupt_store_on_flush(contexts):
    def body(pk, ctx):
        good = pk.bt.mem_array((64,), np.float32,
                               data=np.arange(64, dtype=np.float32), ctx=ctx)
        sched = ctx.scheduler()

        def explode(task):
            raise ValueError("compute failure")
        t = fn_task(pk, explode)
        t.add_write(good.store, *good.block_access(0, 64))
        sched.add_task(t)
        with pytest.raises(RuntimeError):
            sched.wait_for([t], timeout=30)
        sched.flush_cache()
        return good.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port, np.arange(64, dtype=np.float32))
    np.testing.assert_array_equal(port, ref)


def test_successful_task_still_writes_back(contexts):
    def body(pk, ctx):
        out = pk.bt.mem_array((64,), np.float32, ctx=ctx)
        sched = ctx.scheduler()
        w_off, w_si = out.block_access(0, 64)
        key = pk.mod("core.task").access_key(out.store, w_off, w_si)

        def fill(task):
            task.buffers[key].view(np.float32)[:] = 7.0
        t = fn_task(pk, fill)
        t.add_write(out.store, w_off, w_si)
        sched.add_task(t)
        sched.wait_for([t], timeout=30)
        sched.flush_cache()
        return out.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port, np.full(64, 7.0, np.float32))
    np.testing.assert_array_equal(port, ref)


def test_compute_pool_shrink_midstream(contexts):
    """Shrinking the pool mid-stream loses no task and drains to one
    thread; growing it again still runs new work."""
    def body(pk, ctx):
        sched = ctx.scheduler()
        sched.set_num_compute_threads(4)
        done, lock = [], threading.Lock()

        def work(task):
            time.sleep(0.005)
            with lock:
                done.append(task.id)
        tasks = [fn_task(pk, work) for _ in range(40)]
        sched.add_tasks(tasks[:20])
        sched.set_num_compute_threads(1)
        sched.add_tasks(tasks[20:])
        sched.wait_for(tasks, timeout=60)
        seen = [len(done)]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            alive = [t for t in sched._compute_threads if t.is_alive()]
            if len(alive) <= 1 and sched._pending_pills == 0:
                break
            time.sleep(0.01)
        seen.append(len([t for t in sched._compute_threads
                         if t.is_alive()]))
        seen.append(sched._pending_pills)
        sched.set_num_compute_threads(3)
        more = [fn_task(pk, work) for _ in range(10)]
        sched.add_tasks(more)
        sched.wait_for(more, timeout=60)
        return seen + [len(done)]
    ref, port = on_both(contexts, body)
    assert port == ref == [40, 1, 0, 50]


def test_failed_write_entry_not_served_from_cache(contexts):
    """A failed task's write tile is dropped: a later reader gets the
    file's bytes, not the failed task's buffer."""
    def body(pk, ctx):
        arr = pk.bt.mem_array((64,), np.float32,
                              data=np.arange(64, dtype=np.float32), ctx=ctx)
        sched = ctx.scheduler()
        off, sinfo = arr.block_access(0, 64)
        key = pk.mod("core.task").access_key(arr.store, off, sinfo)

        def explode(task):
            task.buffers[key].view(np.float32)[:] = -1.0
            raise ValueError("boom")
        t1 = fn_task(pk, explode)
        t1.add_write(arr.store, off, sinfo)
        sched.add_task(t1)
        with pytest.raises(RuntimeError):
            sched.wait_for([t1], timeout=30)
        got = {}

        def read_back(task):
            got["v"] = task.buffers[key].view(np.float32).copy()
        t2 = fn_task(pk, read_back)
        t2.add_read(arr.store, off, sinfo)
        sched.add_task(t2)
        sched.wait_for([t2], timeout=30)
        return got["v"]
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port, np.arange(64, dtype=np.float32))
    np.testing.assert_array_equal(port, ref)


class _HealingStore:
    """Reads fail the first `n_fail` times, then come from the inner
    store (a transient I/O error)."""

    def __init__(self, pk, inner, n_fail=1):
        self._pk = pk
        self._inner = inner
        self._left = n_fail

    def read(self, offset, sinfo, out):
        if self._left > 0:
            self._left -= 1
            t = self._pk.mod("io.store").Ticket(out)
            t._complete("transient read failure")
            return t
        return self._inner.read(offset, sinfo, out)

    def write(self, offset, sinfo, src):
        return self._inner.write(offset, sinfo, src)

    def flush(self):
        pass


def test_transient_read_error_refetches_on_retry(contexts):
    def body(pk, ctx):
        base = pk.bt.mem_array((64,), np.float32,
                               data=np.arange(64, dtype=np.float32), ctx=ctx)
        healing = _HealingStore(pk, base.store, n_fail=1)
        cache = ctx.scheduler().cache
        off, sinfo = base.block_access(0, 64)
        key = cache.pin_read(healing, off, sinfo)
        with pytest.raises(IOError):
            cache.wait_ready(key, pump=True)
        cache.unpin(key)
        key2 = cache.pin_read(healing, off, sinfo)
        cache.wait_ready(key2, pump=True)
        got = cache.buf(key2).view(np.float32).copy()
        cache.unpin(key2)
        return got
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port, np.arange(64, dtype=np.float32))
    np.testing.assert_array_equal(port, ref)


def test_eviction_write_error_contained_and_reported(tmp_path):
    """A write-back that raises during a dirty eviction does not wedge the
    scheduler: the evicting task completes, and flush_cache() reports the
    lost write as IOError, in both packages."""
    class _WriteExplodes:
        def __init__(self, inner):
            self._inner = inner

        def read(self, offset, sinfo, out):
            return self._inner.read(offset, sinfo, out)

        def write(self, offset, sinfo, src):
            raise IOError("write explosion during eviction")

        def flush(self):
            pass

    def body(pk):
        small = pk.context(tmp_path / pk.name, program_budget=768,
                           n_compute_threads=1)
        try:
            sched = small.scheduler()
            base = pk.bt.mem_array((128,), np.float32, ctx=small)
            bad = _WriteExplodes(base.store)
            off, sinfo = base.block_access(0, 128)  # 512 B
            key = pk.mod("core.task").access_key(bad, off, sinfo)

            def fill(task):
                task.buffers[key].view(np.float32)[:] = 1.0
            t1 = fn_task(pk, fill)
            t1.add_write(bad, off, sinfo)
            sched.add_task(t1)
            sched.wait_for([t1], timeout=30)
            other = pk.bt.mem_array((128,), np.float32, ctx=small)
            t2 = fn_task(pk, lambda task: None)
            t2.add_write(other.store, *other.block_access(0, 128))
            sched.add_task(t2)
            sched.wait_for([t2], timeout=30)
            with pytest.raises(IOError, match="NOT fully persisted") as e:
                sched.flush_cache()
            return type(e.value)
        finally:
            try:
                small.destroy()
            except IOError:
                pass
    ref, port = run_both(body)
    assert port is ref


def test_completion_record_bitmap():
    """The bitmap across growth boundaries: far-apart ids, idempotent
    marks, unmarked ids in range stay incomplete."""
    def trace(pk):
        cr = pk.mod("core.scheduler").CompletionRecord()
        seen = []
        for tid in (0, 7, 8, 8191, 8192, 123_456, 1_000_003):
            seen.append(cr.is_complete(tid))
            cr.mark(tid)
            cr.mark(tid)
            seen.append(cr.is_complete(tid))
        return seen + [cr.is_complete(1_000_002),
                       cr.all_complete([0, 8191, 1_000_003]),
                       cr.all_complete([0, 999_999])]
    ref, port = run_both(trace)
    assert port == ref == [False, True] * 7 + [False, True, False]
