"""The port's native pin cache (`bof_tpu_torch/io/native_cache.py` over the
engine built from bof_tpu_torch/native/), its host prep kernels, and the
pipeline helpers `core/pipeline.py:PrefetchSeq` and `ops/gemm.py:HbmCache`,
against bof_tpu's, case for case after tests/test_native_cache.py and
tests/test_pipeline_units.py: the same pins, evictions, invalidations and
prefetches on both packages must give the same bytes and the same cache
statistics.  bof_tpu's `split_f64_i8` case has no counterpart: the port
leaves that Ozaki helper unbound on purpose, which the last case pins."""
import gc
import time

import numpy as np
import pytest

from torch_pair import BOTH, PORT, REF, engine, run_both

DATA = np.arange(1 << 18, dtype=np.uint32)


def si(pk, stride, n_strides, len_per_stride):
    return pk.mod("io.stride").StrideInfo(
        stride=stride, n_strides=n_strides, len_per_stride=len_per_stride)


def contiguous(pk, nbytes):
    return pk.mod("io.stride").StrideInfo.contiguous(nbytes)


def native_store(pk, tmp_path):
    engine(pk)
    d = tmp_path / pk.name
    d.mkdir(exist_ok=True)
    path = str(d / "nc.bin")
    DATA.tofile(path)
    return pk.mod("io.native").NativeFileStore(path, n_threads=4)


def cache_of(pk, budget):
    return pk.mod("io.native_cache").NativeTileCache(budget)


def test_native_pin_ready_buf_roundtrip(tmp_path):
    def trial(pk):
        st = native_store(pk, tmp_path)
        cache = cache_of(pk, 64 << 20)
        sinfo = si(pk, 4096, 16, 1024)
        key = cache.pin_read(st, 0, sinfo)
        cache.wait_ready(key)
        buf = cache.buf_sized(key, sinfo.nbytes).view(np.uint32).copy()
        key2 = cache.pin_read(st, 0, sinfo)  # a hit
        stats = cache.stats()
        cache.unpin(key)
        cache.unpin(key2)
        gc.collect()
        cache.close()
        st.close()
        return key2 == key, buf, {k: stats[k] for k in ("hits", "misses")}
    (ref_same, ref_buf, ref_stats), (same, buf, stats) = run_both(trial)
    assert same and ref_same
    np.testing.assert_array_equal(buf, np.concatenate(
        [DATA[i * 1024:i * 1024 + 256] for i in range(16)]))
    np.testing.assert_array_equal(buf, ref_buf)
    assert stats == ref_stats == {"hits": 1, "misses": 1}


def test_native_eviction_under_budget_and_borrow_safety(tmp_path):
    """A 2-tile budget over 6 pins evicts; views borrowed from evicted
    entries keep valid data."""
    def trial(pk):
        st = native_store(pk, tmp_path)
        sinfo = contiguous(pk, 64 << 10)
        cache = cache_of(pk, 128 << 10)
        bufs = []
        for i in range(6):
            k = cache.pin_read(st, i * (64 << 10), sinfo)
            cache.wait_ready(k)
            b = cache.buf_sized(k, sinfo.nbytes)
            bufs.append(b.copy() if i < 3 else b)
            cache.unpin(k)
        evictions = cache.stats()["evictions"]
        got = [b.view(np.uint32).copy() for b in bufs[3:]]
        del bufs
        gc.collect()
        cache.close()
        st.close()
        return evictions, got
    (ref_ev, ref_got), (ev, got) = run_both(trial)
    assert ev >= 1 and ref_ev >= 1
    for i, g in zip(range(3, 6), got):
        start = i * (64 << 10) // 4
        np.testing.assert_array_equal(g, DATA[start:start + (64 << 10) // 4])
    for g, r in zip(got, ref_got):
        np.testing.assert_array_equal(g, r)


def test_native_router_mixed_stores(tmp_path):
    """PinRouter sends file stores to the native cache and the rest to the
    Python cache, with the same tagged keys and bytes in both packages."""
    class FakePy:
        """A Python-cache stand-in."""
        def __init__(self):
            self.store = {}

        def pin_read(self, store, off, sinfo):
            k = (off, sinfo)
            self.store[k] = store.read_sync(off, sinfo)
            return k

        def ready(self, k):
            return True

        def buf(self, k):
            return self.store[k]

        def unpin(self, k):
            pass

        def wait_ready(self, k, pump=True):
            pass

    def trial(pk):
        st = native_store(pk, tmp_path)
        mem = pk.mod("io.store").MemStore(4096)
        mem.write(0, contiguous(pk, 4096), np.arange(
            1024, dtype=np.uint32).view(np.uint8).ravel()).wait()
        router = pk.mod("io.native_cache").PinRouter(
            FakePy(), cache_of(pk, 16 << 20))
        s = contiguous(pk, 1024)
        k_nat = router.pin_read(st, 0, s)
        k_py = router.pin_read(mem, 0, s)
        router.wait_ready(k_nat)
        out = (k_nat[0], k_py[0], router.buf(k_nat).view(np.uint32).copy(),
               router.buf(k_py).view(np.uint32).copy())
        router.unpin(k_nat)
        router.unpin(k_py)
        st.close()
        return out
    ref, port = run_both(trial)
    assert port[:2] == ref[:2] == ("__nat__", "__py__")
    np.testing.assert_array_equal(port[2], DATA[:256])
    np.testing.assert_array_equal(port[3], np.arange(256, dtype=np.uint32))
    np.testing.assert_array_equal(port[2], ref[2])


def test_explicit_native_tile_cache_requires_native_io(tmp_path):
    """tile_cache_backend='native' on the python io backend raises the
    same RuntimeError in both packages rather than degrade."""
    messages = []
    for pk in BOTH:
        ctx = pk.context(tmp_path / pk.name, io_backend="python",
                         tile_cache_backend="native")
        try:
            with pytest.raises(RuntimeError, match="native") as e:
                ctx.pin_cache()
            messages.append(str(e.value))
        finally:
            ctx.destroy()
    assert messages[0] == messages[1]


def test_native_prep_kernels_match_numpy():
    """`quantize_i8` and `cast_bf16` (the transfer modes' host prep): the
    port's bits are bof_tpu's (its bf16 as uint16 bits, without
    ml_dtypes), and both match the numpy goldens (bf16 bit for bit, int8
    within one quantum); a zero tile and NaN/inf edges too."""
    import ml_dtypes
    rng = np.random.default_rng(42)
    h = (rng.standard_normal((333, 257)) * 1e3).astype(np.float32)
    ref_n, port_n = REF.mod("io.native"), PORT.mod("io.native")
    engine(PORT)

    q, scale = port_n.quantize_i8(h)
    q_ref, scale_ref = ref_n.quantize_i8(h)
    np.testing.assert_array_equal(q, q_ref)
    assert np.float32(scale) == np.float32(scale_ref)
    amax = float(np.abs(h).max())
    q_np = np.rint(h * (127.0 / amax)).astype(np.int8)
    assert abs(scale - amax / 127.0) / (amax / 127.0) < 1e-6
    assert np.abs(q.astype(np.int16) - q_np.astype(np.int16)).max() <= 1

    b = port_n.cast_bf16(h)
    assert b.dtype == np.uint16
    np.testing.assert_array_equal(b, ref_n.cast_bf16(h).view(np.uint16))
    np.testing.assert_array_equal(
        b, h.astype(ml_dtypes.bfloat16).view(np.uint16))

    z, sz = port_n.quantize_i8(np.zeros((16, 16), np.float32))
    assert abs(sz - 1.0 / 127.0) < 1e-9 and not z.any()
    nn = np.array([np.nan, 1.0, -np.inf], np.float32)
    bn = port_n.bf16_to_f32(port_n.cast_bf16(nn))
    assert np.isnan(bn[0]) and bn[1] == 1.0 and np.isneginf(bn[2])
    np.testing.assert_array_equal(port_n.cast_bf16(nn),
                                  ref_n.cast_bf16(nn).view(np.uint16))


def test_native_split_f64_i8_is_not_bound():
    """bof_tpu's `split_f64_i8` (and `fold_i32_f64`) prepare the Ozaki
    slices of its emulated fp64 gemm; the port multiplies float64 on the
    card's fp64 tensor cores and leaves both unbound, so bof_tpu's case
    (tests/test_native_cache.py:159) has nothing to hold."""
    engine(PORT)
    for name in ("split_f64_i8", "fold_i32_f64"):
        assert hasattr(REF.mod("io.native"), name), name
        assert not hasattr(PORT.mod("io.native"), name), name
    assert not hasattr(PORT.mod("ops.gemm64"), "_split_slices")


def test_native_invalidate_orphans_in_flight_read(tmp_path):
    """Invalidating an unpinned entry whose read may still be in flight
    orphans it; a re-pin misses and reads fresh bytes, and the orphan is
    reaped once its read lands."""
    def trial(pk):
        st = native_store(pk, tmp_path)
        cache = cache_of(pk, 64 << 20)
        sinfo = contiguous(pk, 1 << 20)
        k1 = cache.pin_read(st, 0, sinfo)
        cache.unpin(k1)
        dropped = cache.invalidate(st.uid, 0, sinfo.nbytes)
        k2 = cache.pin_read(st, 0, sinfo)
        cache.wait_ready(k2)
        buf = cache.buf_sized(k2, sinfo.nbytes).view(np.uint32).copy()
        cache.unpin(k2)
        for _ in range(200):
            if cache.stats()["entries"] <= 1:
                break
            k = cache.pin_read(st, 4096, contiguous(pk, 4096))
            cache.wait_ready(k)
            cache.unpin(k)
            cache.invalidate(st.uid, 4096, 8192)
            time.sleep(0.002)
        entries = cache.stats()["entries"]
        cache.close()
        st.close()
        return dropped, k2 != k1, buf, entries
    ref, port = run_both(trial)
    assert port[:2] == ref[:2] == (1, True)
    np.testing.assert_array_equal(port[2], DATA[:(1 << 20) // 4])
    np.testing.assert_array_equal(port[2], ref[2])
    assert port[3] <= 1 and ref[3] <= 1


@pytest.fixture
def contexts(tmp_path):
    ctxs = [pk.context(tmp_path / pk.name) for pk in BOTH]
    yield ctxs
    for c in ctxs:
        c.destroy()


def test_prefetch_seq_in_order(contexts):
    data = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    got = []
    for pk, ctx in zip(BOTH, contexts):
        arr = pk.bt.mem_array((4096,), np.float32, data=data, ctx=ctx)
        accesses = [(arr.store,) + arr.block_access(i * 256, 256)
                    for i in range(16)]
        pf = pk.mod("core.pipeline").PrefetchSeq(ctx.scheduler().cache,
                                                 accesses, depth=3)
        bufs = []
        for i in range(16):
            bufs.append(pf.get(i).view(np.float32).copy())
            pf.done(i)
        pf.close()
        got.append(np.concatenate(bufs))
    np.testing.assert_array_equal(got[1], data)
    np.testing.assert_array_equal(got[1], got[0])


def test_prefetch_seq_close_releases(contexts):
    """close() with pins outstanding unpins all of them: a flush then
    leaves nothing pinned, in both packages."""
    data = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
    for pk, ctx in zip(BOTH, contexts):
        arr = pk.bt.mem_array((1024,), np.float32, data=data, ctx=ctx)
        cache = ctx.scheduler().cache
        accesses = [(arr.store,) + arr.block_access(i * 128, 128)
                    for i in range(8)]
        pf = pk.mod("core.pipeline").PrefetchSeq(cache, accesses, depth=8)
        pf.get(0)
        pf.close()
        cache.flush()
        assert cache.active_count == 0, pk


def test_hbm_cache_lru_and_budget():
    class FakeArr:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    def trace(pk):
        c = pk.mod("ops.gemm").HbmCache(budget_bytes=300)
        a = FakeArr(100)
        c.put("a", a, 100)
        c.put("b", FakeArr(100), 100)
        c.put("c", FakeArr(100), 100)
        seen = [c.get("a") is a]        # promotes 'a'
        c.put("d", FakeArr(100), 100)   # evicts the LRU, 'b'
        seen += [c.get("b") is None, c.get("a") is a, c.peek("d"),
                 c.peek("b")]
        c.clear()
        return seen + [c.get("a") is None]
    ref, port = run_both(trace)
    assert port == ref == [True, True, True, True, False, True]
