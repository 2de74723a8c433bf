"""The port's Program Cache, flash arrays and pin caches
(`bof_tpu_torch/core/{cache,flash_array}.py`, `io/native_cache.py`, and the
device tile cache of `ops/gemm.py`) against bof_tpu's, case for case after
tests/test_cache_races.py and tests/test_coherence.py: the accounting
races driven by a store whose reads complete when the test says, and the
coherence of direct writes, where a write between two gemms must reach
the second gemm.  Each case runs on both packages and must give the same
counts, the same bytes and the same C."""
import collections
import gc

import numpy as np
import pytest

from torch_pair import BOTH, engine, run_both


def contiguous(pk, nbytes):
    return pk.mod("io.stride").StrideInfo.contiguous(nbytes)


def slow_store(pk, nbytes=1 << 20):
    """A store whose reads stay in flight until `complete_one`, whose
    writes finish at once, counting the reads issued."""
    store = pk.mod("io.store")

    class SlowStore(store.BaseStore):
        def __init__(self):
            self._data = np.zeros(nbytes, np.uint8)
            self.pending = []
            self.reads = 0

        def size(self):
            return self._data.nbytes

        def read(self, offset, sinfo, out):
            t = store.Ticket(out)
            self.reads += 1
            self.pending.append((t, offset, sinfo, out))
            return t

        def write(self, offset, sinfo, src):
            return store.Ticket.completed()

        def complete_one(self, idx=0):
            t, off, sinfo, out = self.pending.pop(idx)
            out[:sinfo.nbytes] = 7
            t._complete()

        def flush(self):
            pass

        def close(self):
            pass

    return SlowStore()


def tile_cache(pk, **kw):
    return pk.mod("core.cache").TileCache(**kw)


# ------------------------------------------------ test_cache_races.py

def test_backlog_duplicate_key_serviced_once():
    """Evict-then-repin queues a key twice; it is serviced once."""
    def trace(pk):
        st, si = slow_store(pk), contiguous(pk, 4096)
        cache = tile_cache(pk, max_size=1 << 20)
        k = cache.pin_read(st, 0, si)
        cache.unpin(k)
        with cache._lock:
            cache._evict_locked(k)
        seen = [cache.active_count]
        k = cache.pin_read(st, 0, si)
        cache.service_backlog()
        seen += [st.reads, cache.real_size]
        st.complete_one()
        cache.service_backlog()
        seen += [cache.ready(k), int(cache.buf(k)[0])]
        cache.unpin(k)
        return seen
    ref, port = run_both(trace)
    assert port == ref == [0, 1, 4096, True, 7]


def test_aborted_stream_orphans_inflight_read():
    """Dropping a pinned entry with its read in flight orphans the ticket:
    the re-pinned key completes only on its own read."""
    def trace(pk):
        st, si = slow_store(pk), contiguous(pk, 4096)
        cache = tile_cache(pk, max_size=1 << 20, single_use_discard=True)
        k = cache.pin_read(st, 0, si)
        cache.service_backlog()
        seen = [st.reads]
        cache.unpin(k)
        k = cache.pin_read(st, 0, si)
        st.complete_one(0)
        cache.service_backlog()
        seen += [cache.ready(k), st.reads]
        st.complete_one(0)
        cache.service_backlog()
        seen.append(cache.ready(k))
        cache.unpin(k)
        return seen
    ref, port = run_both(trace)
    assert port == ref == [1, False, 2, True]


def test_allocate_rolls_back_on_exception():
    """An exception inside allocate() leaves no ref and no entry."""
    class Boom(RuntimeError):
        pass

    class ExplodingBacklog(list):
        def append(self, item):
            raise Boom("mid-loop failure")

    def trace(pk):
        FnTask = pk.mod("core.task").FnTask
        st, si = slow_store(pk), contiguous(pk, 4096)
        cache = tile_cache(pk, max_size=1 << 20)
        warm = FnTask(lambda task: None)
        warm.add_read(st, 0, si)
        seen = [bool(cache.allocate(warm))]
        pre_commit = cache.commit_size
        t = FnTask(lambda task: None)
        t.add_read(st, 0, si)
        t.add_read(st, 8192, si)
        cache._backlog = ExplodingBacklog()
        with pytest.raises(Boom):
            cache.allocate(t)
        cache._backlog = collections.deque()
        a_key = next(iter(cache._entries))
        return seen + [cache.commit_size == pre_commit, cache.active_count,
                       cache._entries[a_key].refs]
    ref, port = run_both(trace)
    assert port == ref == [True, True, 1, 1]


# ---------------------------------------------------- test_coherence.py

def contexts_for(tmp_path, **kw):
    return {pk.name: pk.context(tmp_path / f"{pk.name}_scratch", **kw)
            for pk in BOTH}


@pytest.fixture
def contexts(tmp_path):
    ctxs = contexts_for(tmp_path)
    yield ctxs
    for c in ctxs.values():
        c.destroy()


@pytest.fixture
def pycontexts(tmp_path):
    ctxs = contexts_for(tmp_path, io_backend="python")
    yield ctxs
    for c in ctxs.values():
        c.destroy()


def gemm_rewrite_gemm(contexts, make, shape, tmp_path):
    """gemm, rewrite A directly, gemm again, on each package: the second C
    must see the new A (no stale pin-cache or device tile), and the
    port's C must be bof_tpu's within rtol 2e-4 both times."""
    rng = np.random.default_rng(0)
    a, b, a2 = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(3))
    outs = []
    for pk in BOTH:
        ctx = contexts[pk.name]
        A, B, C = (make(pk, ctx, tmp_path / pk.name, name, x)
                   for name, x in (("a", a), ("b", b), ("c", None)))
        gemm = pk.mod("ops.gemm").gemm
        gemm(A, B, C, blk=32, ctx=ctx)
        first = C.read_all()
        A.write_all(a2)
        gemm(A, B, C, blk=32, ctx=ctx)
        outs.append((first, C.read_all()))
    (ref1, ref2), (got1, got2) = outs
    np.testing.assert_allclose(got1, a @ b, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got2, a2 @ b, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got1, ref1, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got2, ref2, rtol=2e-4, atol=1e-5)


def file_operand(pk, ctx, d, name, data):
    d.mkdir(exist_ok=True)
    arr = pk.bt.map_array(str(d / f"{name}.bin"), (64, 64), np.float32,
                          "R", create=True, ctx=ctx)
    if data is not None:
        arr.write_all(data)
    return arr


def test_native_write_all_invalidates_pin_cache(contexts, tmp_path):
    """File arrays on the native backend pin through the engine's cache: a
    direct rewrite of A between gemms must invalidate it."""
    for pk in BOTH:
        engine(pk)
    gemm_rewrite_gemm(contexts, file_operand, (64, 64), tmp_path)


def test_write_all_invalidates_python_pin_cache(pycontexts, tmp_path):
    gemm_rewrite_gemm(pycontexts, file_operand, (64, 64), tmp_path)


def test_mem_array_rewrite_between_gemms(contexts, tmp_path):
    def mem_operand(pk, ctx, d, name, data):
        return pk.bt.mem_array((48, 48), np.float32, "R", data=data,
                               ctx=ctx)
    gemm_rewrite_gemm(contexts, mem_operand, (48, 48), tmp_path)


def test_partial_block_write_invalidates_only_overlap(contexts):
    """write_block over one tile's rows drops exactly the overlapping
    entries: the disjoint tile stays a hit, the rewritten one re-reads."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    patch = rng.standard_normal((16, 64)).astype(np.float32)

    def body(pk):
        ctx = contexts[pk.name]
        metrics = pk.mod("utils").METRICS
        A = pk.bt.mem_array((64, 64), np.float32, "R", data=a, ctx=ctx)
        cache = ctx.pin_cache()
        for r0 in (0, 48):
            k = cache.pin_read(A.store, *A.block_access(r0, 16, 0, 64))
            cache.wait_ready(k)
            cache.unpin(k)
        A.write_block(0, patch)
        before = metrics.get("cache.hit")
        k_bot = cache.pin_read(A.store, *A.block_access(48, 16, 0, 64))
        hit = metrics.get("cache.hit") - before
        cache.wait_ready(k_bot)
        cache.unpin(k_bot)
        k_top = cache.pin_read(A.store, *A.block_access(0, 16, 0, 64))
        cache.wait_ready(k_top)
        got = cache.buf(k_top).view(np.float32).reshape(16, 64).copy()
        cache.unpin(k_top)
        return hit, got
    (ref_hit, ref_got), (hit, got) = run_both(body)
    assert hit == ref_hit == 1, "disjoint tile evicted"
    np.testing.assert_array_equal(got, patch)
    np.testing.assert_array_equal(got, ref_got)


def test_dirty_cached_tile_evicts_before_direct_write():
    """An overlapping dirty write-back lands before the direct write."""
    def body(pk):
        cache = tile_cache(pk, max_size=64 << 20)
        st = pk.mod("io.store").MemStore(4096)
        si = contiguous(pk, 1024)
        k = cache.pin_read(st, 0, si)
        cache.wait_ready(k)
        e = cache._entries[k]
        e.buf[:] = 7
        e.dirty = True
        cache.unpin(k)
        cache.invalidate_overlap(st, 0, contiguous(pk, 512))
        st.write_sync(0, contiguous(pk, 512), np.full(512, 9, np.uint8))
        return st.read_sync(0, si).copy(), k in cache._entries
    (ref, ref_kept), (got, kept) = run_both(body)
    assert (got[:512] == 9).all(), "direct write lost to stale write-back"
    assert (got[512:] == 7).all(), "dirty tail not written back"
    assert not kept and not ref_kept
    np.testing.assert_array_equal(got, ref)


def test_native_cache_invalidate_unit(tmp_path):
    """invalidate() drops the overlapping tile only: the rewritten range
    re-reads fresh bytes, the disjoint tile stays a hit."""
    data = np.arange(1 << 16, dtype=np.uint32)

    def body(pk):
        engine(pk)
        path = str(tmp_path / f"{pk.name}_inv.bin")
        data.tofile(path)
        st = pk.mod("io.native").NativeFileStore(path, n_threads=2)
        cache = pk.mod("io.native_cache").NativeTileCache(64 << 20)
        si = contiguous(pk, 4096)
        k1 = cache.pin_read(st, 0, si)
        k2 = cache.pin_read(st, 8192, si)
        for k in (k1, k2):
            cache.wait_ready(k)
            cache.unpin(k)
        dropped = cache.invalidate(st.uid, 0, 4096)
        st.write_sync(0, si, np.zeros(4096, np.uint8))
        k1b = cache.pin_read(st, 0, si)
        cache.wait_ready(k1b)
        got = cache.buf_sized(k1b, si.nbytes).view(np.uint32).copy()
        k2b = cache.pin_read(st, 8192, si)
        cache.unpin(k1b)
        cache.unpin(k2b)
        gc.collect()
        cache.close()
        st.close()
        return dropped, got, k2b == k2
    ref, port = run_both(body)
    assert port[0] == ref[0] == 1
    assert not port[1].any(), "stale tile served after invalidate"
    assert port[2] and ref[2], "disjoint tile should remain a hit"


def test_uid_counts_stay_in_sync():
    """_UidKeyedDict's per-uid counts follow every mutation path."""
    def trace(pk):
        d = pk.mod("core.cache")._UidKeyedDict()
        d[(1, 0, "a")] = "x"
        d[(1, 8, "b")] = "y"
        d[(2, 0, "a")] = "z"
        seen = [dict(d.uid_counts)]
        d[(1, 0, "a")] = "x2"
        seen.append(d.uid_counts[1])
        seen.append(d.pop((1, 0, "a")))
        seen.append(dict(d.uid_counts))
        seen.append(d.pop((1, 0, "a"), None))
        del d[(2, 0, "a")]
        seen.append(2 in d.uid_counts)
        del d[(1, 8, "b")]
        return seen + [dict(d.uid_counts), dict(d)]
    ref, port = run_both(trace)
    assert port == ref == [{1: 2, 2: 1}, 2, "x2", {1: 1, 2: 1}, None,
                           False, {}, {}]


def stale_pinned_tile(contexts, tmp_path, n):
    """A direct write under a pin cannot drop the pinned tile, but the
    staleness dies with the pin: the next pin reads the new bytes."""
    rng = np.random.default_rng(0)
    data, data2 = (rng.standard_normal(n).astype(np.float32)
                   for _ in range(2))
    for pk in BOTH:
        ctx = contexts[pk.name]
        A = pk.bt.map_array(str(tmp_path / f"{pk.name}_s.bin"), (n,),
                            np.float32, create=True, ctx=ctx)
        A.write_all(data)
        cache = ctx.pin_cache()
        off, sinfo = A.block_access(0, n)
        pin = cache.pin_read(A.store, off, sinfo)
        cache.wait_ready(pin)
        np.testing.assert_array_equal(
            cache.buf(pin).view(np.float32)[:n], data)
        A.write_all(data2)
        cache.unpin(pin)
        pin2 = cache.pin_read(A.store, off, sinfo)
        cache.wait_ready(pin2)
        got = cache.buf(pin2).view(np.float32)[:n].copy()
        cache.unpin(pin2)
        np.testing.assert_array_equal(got, data2, err_msg=pk.name)


def test_native_stale_pinned_tile_drops_at_unpin(contexts, tmp_path):
    for pk in BOTH:
        engine(pk)
    stale_pinned_tile(contexts, tmp_path, 4096)


def test_stale_pinned_tile_drops_at_unpin_python(pycontexts, tmp_path):
    stale_pinned_tile(pycontexts, tmp_path, 2048)


def test_flash_truncate_invalidates_cut_range(contexts, tmp_path):
    """flash_truncate drops cached tiles of the cut range: bytes written
    there later through the raw store are what the next pin reads."""
    data = (np.arange(4096) + 1).astype(np.float32)

    def body(pk):
        ctx = contexts[pk.name]
        A = pk.bt.map_array(str(tmp_path / f"{pk.name}_t.bin"), (4096,),
                            np.float32, create=True, ctx=ctx)
        A.write_all(data)
        cache = ctx.pin_cache()
        off, sinfo = A.block_access(2048, 2048)
        pin = cache.pin_read(A.store, off, sinfo)
        cache.wait_ready(pin)
        cache.unpin(pin)
        T = pk.bt.flash_truncate(A, 2048)
        A.store.truncate(4096 * 4)
        A.store.write(2048 * 4, contiguous(pk, 2048 * 4),
                      np.zeros(2048, np.float32).view(np.uint8)).wait()
        A.store.flush()
        pin2 = cache.pin_read(A.store, off, sinfo)
        cache.wait_ready(pin2)
        got = cache.buf(pin2).view(np.float32)[:2048].copy()
        cache.unpin(pin2)
        return T.shape, got
    (ref_shape, ref), (shape, got) = run_both(body)
    assert shape == ref_shape == (2048,)
    np.testing.assert_array_equal(got, np.zeros(2048, np.float32))
    np.testing.assert_array_equal(got, ref)


def test_uid_keyed_dict_rejects_count_blind_mutators():
    for pk in BOTH:
        d = pk.mod("core.cache")._UidKeyedDict()
        d[(1, 0, "a")] = "x"
        for call in (d.clear, lambda: d.update({(2, 0, "b"): "y"}),
                     lambda: d.setdefault((3, 0, "c"), "z"), d.popitem):
            with pytest.raises(NotImplementedError):
                call()
        assert d.uid_counts == {1: 1}, pk


def test_map_array_zero_line_shape(contexts, tmp_path):
    shapes = [pk.bt.map_array(str(tmp_path / f"{pk.name}_z.bin"), (0, 64),
                              np.float32, "R", create=True,
                              ctx=contexts[pk.name], ld=128).shape
              for pk in BOTH]
    assert shapes[0] == shapes[1] == (0, 64)
