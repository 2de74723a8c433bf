"""Page-locking the Program Cache buffers that uploads read whole
(`native/bof_cache.inc`: `bof_cache_lock`, the unlock before every free,
the recycling of a locked buffer; `io/native_cache.py`; the call sites in
`ops/gemm.py`, `parallel/mesh.py:gemm_sharded` and `apps/xml_rank.py`),
on the CPU with a fake pair of lock and unlock functions in place of the
CUDA runtime's.  The fake records each address it locks with the bytes
the buffer held then, refuses a second lock of a locked address (as
cudaHostRegister does) and, at unlock, checks that the buffer still
holds those bytes (or, where the cache reuses a locked buffer for another
tile, one of the tiles it may hold), so an unlock after a free, or a free
under a reader, shows as a changed buffer.  A fake that refuses every lock stands for a
sandbox that forbids page-locking."""
import ctypes
import gc
import importlib

import numpy as np
import pytest
import scipy.sparse as sps

import bof_tpu_torch as bt
from bof_tpu_torch.io.native import NativeFileStore
from bof_tpu_torch.io.native_cache import NativeTileCache
from bof_tpu_torch.io.stride import StrideInfo
from bof_tpu_torch.ops import device as dev
from bof_tpu_torch.utils import METRICS

F32 = np.float32
DATA = np.arange(1 << 18, dtype=np.uint32)
TILE = 64 << 10

_REG = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                        ctypes.c_uint)
_UNREG = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
_CLEAR = ctypes.CFUNCTYPE(ctypes.c_int)


class FakeLock:
    """cudaHostRegister / cudaHostUnregister / cudaGetLastError stand-ins
    that record what the cache asks of them."""

    def __init__(self, refuse: bool = False, tiles=frozenset()):
        self.refuse = refuse
        self.tiles = tiles   # the bytes of every tile a buffer may hold
        self.held = {}       # address -> the bytes the buffer held at lock
        self.locked = []     # (address, nbytes) of every lock, in order
        self.unlocked = []   # address of every unlock, in order
        self.refused = 0
        self.clears = 0
        self.errors = []
        # the callbacks must outlive every native call that may use them
        self._fns = (_REG(self._register), _UNREG(self._unregister),
                     _CLEAR(self._clear))

    def fns(self):
        return tuple(ctypes.cast(f, ctypes.c_void_p).value
                     for f in self._fns)

    def _register(self, addr, nbytes, flags):
        if self.refuse:
            self.refused += 1
            return 1
        if addr in self.held:
            self.errors.append(f"lock of a locked buffer {addr:#x}")
            return 712  # cudaErrorHostMemoryAlreadyRegistered
        self.held[addr] = ctypes.string_at(addr, nbytes)
        self.locked.append((addr, nbytes))
        return 0

    def _unregister(self, addr):
        snap = self.held.pop(addr, None)
        if snap is None:
            self.errors.append(f"unlock of an unlocked buffer {addr:#x}")
            return 713  # cudaErrorHostMemoryNotRegistered
        now = ctypes.string_at(addr, len(snap))
        if now != snap and now not in self.tiles:
            self.errors.append(f"buffer {addr:#x} changed before its unlock")
        self.unlocked.append(addr)
        return 0

    def _clear(self):
        self.clears += 1
        return 0


def _store(tmp_path):
    path = str(tmp_path / "nc.bin")
    DATA.tofile(path)
    return NativeFileStore(path, n_threads=2)


def _pin(cache, st, i, nbytes=TILE):
    key = cache.pin_read(st, i * TILE, StrideInfo.contiguous(nbytes))
    cache.wait_ready(key)
    return key


def _tile(i, nbytes=TILE):
    return DATA.view(np.uint8)[i * TILE:i * TILE + nbytes]


def _addr(cache, key, nbytes=TILE):
    view = cache.buf_sized(key, nbytes)
    return view.ctypes.data, view


@pytest.fixture
def fake():
    return FakeLock()


@pytest.fixture
def st(tmp_path):
    s = _store(tmp_path)
    yield s
    s.close()


def test_lock_is_a_no_op_without_the_functions(st):
    cache = NativeTileCache(4 * TILE)
    try:
        k = _pin(cache, st, 0)
        assert cache.lock(k, TILE) is False
        cache.unpin(k)
        s = cache.stats()
        assert (s["locks"], s["lock_fails"], s["unlocks"]) == (0, 0, 0)
    finally:
        cache.close()


def test_a_locked_buffer_stays_locked_and_is_counted(st, fake):
    cache = NativeTileCache(4 * TILE, fake.fns())
    try:
        k = _pin(cache, st, 0)
        before = METRICS.get("pin_cache.lock_s")
        assert cache.lock(k, TILE) and cache.lock(k, TILE)
        assert METRICS.get("pin_cache.lock_s") > before
        cache.unpin(k)
        k2 = _pin(cache, st, 0)  # a hit: the same buffer, still locked
        assert k2 == k and cache.lock(k2, TILE)
        cache.unpin(k2)
        s = cache.stats()
        assert (s["locks"], s["lock_bytes"], s["lock_fails"]) == (1, TILE, 0)
        assert s["lock_s"] >= 0 and len(fake.locked) == 1
        assert fake.held == {fake.locked[0][0]: _tile(0).tobytes()}
    finally:
        cache.close()
    assert fake.unlocked == [fake.locked[0][0]] and not fake.held
    assert not fake.errors


def test_a_lock_needs_a_pin(st, fake):
    cache = NativeTileCache(4 * TILE, fake.fns())
    try:
        k = _pin(cache, st, 0)
        cache.unpin(k)
        assert cache.lock(k, TILE) is False and not fake.locked
    finally:
        cache.close()


def _evict_by_other_size(cache, st):
    """Misses of another size evict every unpinned entry and recycle
    nothing."""
    for i in range(4, 8):
        cache.unpin(_pin(cache, st, i, TILE // 2))


def _evict_by_invalidate(cache, st):
    assert cache.invalidate(st.uid, 0, len(DATA) * 4) >= 1


def _evict_by_destroy(cache, st):
    cache.close()


@pytest.mark.parametrize("evict", [_evict_by_other_size,
                                   _evict_by_invalidate, _evict_by_destroy])
def test_every_locked_buffer_is_unlocked_once_before_its_free(st, fake,
                                                             evict):
    cache = NativeTileCache(2 * TILE, fake.fns())
    try:
        addrs = []
        for i in range(2):
            k = _pin(cache, st, i)
            assert cache.lock(k, TILE)
            addrs.append(_addr(cache, k)[0])
            cache.unpin(k)
        gc.collect()
        evict(cache, st)
        assert sorted(fake.unlocked) == sorted(addrs)
        assert not fake.held and not fake.errors
        if evict is not _evict_by_destroy:
            assert cache.stats()["unlocks"] == 2
    finally:
        cache.close()


@pytest.mark.parametrize("late", ["unpin", "return"])
def test_a_buffer_in_use_is_unlocked_only_once_its_user_lets_go(st, fake,
                                                               late):
    """An entry dropped while still pinned (a write overlapped it) or
    while a view of it lives (evicted under a borrow) keeps its buffer
    locked and whole; the late unpin or the view's release unlocks it,
    and a view that outlives `destroy` keeps its buffer (leaked)."""
    cache = NativeTileCache(2 * TILE, fake.fns())
    try:
        k = _pin(cache, st, 0)
        assert cache.lock(k, TILE)
        addr, view = _addr(cache, k)
        if late == "unpin":
            del view
            gc.collect()
            # pinned: marked stale, dropped at its last unpin
            assert cache.invalidate(st.uid, 0, TILE) == 0
            assert not fake.unlocked
            cache.unpin(k)
        else:
            cache.unpin(k)
            _evict_by_other_size(cache, st)
            assert cache.stats()["evictions"] >= 1
            assert not fake.unlocked  # the view still reads it
            np.testing.assert_array_equal(view, _tile(0))
            del view
            gc.collect()
        assert fake.unlocked == [addr] and not fake.errors
    finally:
        cache.close()


def test_a_view_that_outlives_destroy_keeps_its_buffer_locked(st, fake):
    cache = NativeTileCache(2 * TILE, fake.fns())
    k = _pin(cache, st, 0)
    assert cache.lock(k, TILE)
    view = cache.buf_sized(k, TILE)
    cache.unpin(k)
    cache._lib.bof_cache_destroy(cache._h)  # close() would collect first
    cache._h = 0
    assert not fake.unlocked
    np.testing.assert_array_equal(view, _tile(0))
    del view
    gc.collect()
    assert not fake.unlocked and not fake.errors  # leaked, never freed


def test_a_miss_takes_an_evicted_locked_buffer_of_its_size(st):
    fake = FakeLock(tiles={_tile(i).tobytes() for i in range(6)})
    cache = NativeTileCache(2 * TILE, fake.fns())
    try:
        addrs = []
        for i in range(2):
            k = _pin(cache, st, i)
            assert cache.lock(k, TILE)
            addrs.append(_addr(cache, k)[0])
            cache.unpin(k)
        gc.collect()
        for i in range(2, 6):  # each miss evicts the oldest, locked tile
            k = _pin(cache, st, i)
            addr, view = _addr(cache, k)
            assert addr in addrs
            assert cache.lock(k, TILE)  # still locked: no new lock
            np.testing.assert_array_equal(view, _tile(i))
            del view
            cache.unpin(k)
            gc.collect()
            assert cache.stats()["used"] <= 2 * TILE
        s = cache.stats()
        assert (s["recycles"], s["locks"], s["unlocks"]) == (4, 2, 0)
        assert len(fake.locked) == 2 and not fake.unlocked
    finally:
        cache.close()
    assert sorted(fake.unlocked) == sorted(addrs) and not fake.errors


def test_a_miss_of_another_size_recycles_nothing(st, fake):
    cache = NativeTileCache(TILE, fake.fns())
    try:
        k = _pin(cache, st, 0)
        assert cache.lock(k, TILE)
        addr = _addr(cache, k)[0]
        cache.unpin(k)
        gc.collect()
        k = _pin(cache, st, 1, TILE // 2)
        assert fake.unlocked == [addr]
        assert cache.stats()["recycles"] == 0
        assert cache.lock(k, TILE // 2) and len(fake.locked) == 2
        cache.unpin(k)
    finally:
        cache.close()
    assert not fake.held and not fake.errors


def test_a_refused_lock_leaves_the_buffer_pageable_and_counted(st):
    fake = FakeLock(refuse=True)
    cache = NativeTileCache(2 * TILE, fake.fns())
    try:
        k = _pin(cache, st, 0)
        assert cache.lock(k, TILE) is False
        assert cache.lock(k, TILE) is False  # tried once, not again
        np.testing.assert_array_equal(cache.buf_sized(k, TILE), _tile(0))
        cache.unpin(k)
        gc.collect()
        s = cache.stats()
        assert (s["locks"], s["lock_fails"]) == (0, 1)
        assert (fake.refused, fake.clears) == (1, 1)
        _evict_by_invalidate(cache, st)
    finally:
        cache.close()
    assert not fake.unlocked and not fake.errors


@pytest.mark.parametrize("case", ["view", "reshaped", "slice", "cast",
                                  "padded", "transposed"])
def test_is_whole_is_true_only_for_the_buffer_as_it_stands(case):
    buf = np.arange(64, dtype=np.uint8)
    arr = {"view": lambda: buf.view(F32).reshape(4, 4),
           "reshaped": lambda: buf.reshape(8, 8),
           "slice": lambda: buf[:32],
           "cast": lambda: buf.astype(F32),
           "padded": lambda: np.pad(buf.reshape(8, 8), ((0, 1), (0, 0))),
           "transposed": lambda: buf.reshape(8, 8).T}[case]()
    assert dev.is_whole(arr, buf) is (case in ("view", "reshaped"))


def test_to_device_counts_every_upload(fake):
    before = METRICS.snapshot()
    x = np.arange(100, dtype=F32)
    dev.to_device(x, dev.resolve_device("cpu"))
    after = METRICS.snapshot()
    assert after["h2d.bytes"] - before.get("h2d.bytes", 0) == x.nbytes
    # a CPU device has no page-locked source
    assert after.get("h2d.locked_bytes", 0) == before.get(
        "h2d.locked_bytes", 0)


def test_a_cpu_context_hands_the_cache_no_functions(tmp_path):
    assert dev.host_lock_fns(dev.resolve_device("cpu")) is None


# ---- the call sites -----------------------------------------------------

M = N = K = 64
BLK = 16


def _ctx(tmp_path, **kw):
    cfg = dict(device="cpu", scratch_dir=str(tmp_path / "scratch"),
               io_backend="native", n_io_threads=2, program_budget=64 << 20)
    cfg.update(kw)
    return bt.FlashContext(bt.FlashConfig(**cfg))


def _with_fake(monkeypatch, fake):
    """Contexts made from now on hand their pin cache `fake`'s functions
    (None: none, as on a CPU device)."""
    monkeypatch.setattr(dev, "host_lock_fns",
                        lambda device: fake and fake.fns())


def _gemm(tmp_path, tag, fake, monkeypatch, *, m=M, n=N, k=K, sharded=False,
          shard_reads=False, calls=2, **cfg_kw):
    """gemm (or gemm_sharded on a world of one rank) of A, B in files
    through the native pin cache, `calls` times; C's bytes of each call,
    the cache's counters and the fake's record at the end."""
    _with_fake(monkeypatch, fake)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((m, k)).astype(F32)
    b = rng.standard_normal((k, n)).astype(F32)
    d = tmp_path / tag
    d.mkdir()
    a.tofile(str(d / "A"))
    b.tofile(str(d / "B"))
    ctx = _ctx(d, **cfg_kw)
    outs = []
    try:
        A = bt.map_array(str(d / "A"), (m, k), F32, ctx=ctx)
        B = bt.map_array(str(d / "B"), (k, n), F32, ctx=ctx)
        for i in range(calls):
            C = bt.mem_array((m, n), F32, ctx=ctx)
            if sharded:
                from torch_dist_pool import one_rank_world

                from bof_tpu_torch.parallel import gemm_sharded
                from bof_tpu_torch.parallel import mesh as meshmod
                meshmod._FORCE_SHARDED_READS = shard_reads
                try:
                    with one_rank_world() as mesh:
                        gemm_sharded(A, B, C, alpha=0.5 + i, blk=BLK,
                                     mesh=mesh, ctx=ctx)
                finally:
                    meshmod._FORCE_SHARDED_READS = False
            else:
                bt.gemm(A, B, C, alpha=0.5 + i, blk=BLK, ctx=ctx)
            outs.append(C.read_all().tobytes())
        stats = ctx.pin_cache_stats()
        gc.collect()
    finally:
        ctx.destroy()
    want = 0.5 * (a.astype(np.float64) @ b)
    tol = {"int8": 5e-2, "bfloat16": 2e-2}.get(
        cfg_kw.get("transfer_dtype"), 2e-4) * np.abs(want).max()
    np.testing.assert_allclose(np.frombuffer(outs[0], F32).reshape(m, n),
                               want, rtol=0, atol=tol)
    return outs, stats


GEMM_CASES = {
    "fp32": dict(),
    "fp32_edge": dict(m=M - 5, n=N - 3),
    "fp32_misses": dict(program_budget=6 * BLK * BLK * 4),
    "bf16": dict(transfer_dtype="bfloat16"),
    "int8": dict(transfer_dtype="int8"),
    "sharded": dict(sharded=True),
    "sharded_reads": dict(sharded=True, shard_reads=True),
}


def _tiles(m=M, n=N, k=K, **_):
    """The bytes of every whole BLK x BLK tile of A and B (`_gemm`'s)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((m, k)).astype(F32)
    b = rng.standard_normal((k, n)).astype(F32)
    return {x[i:i + BLK, j:j + BLK].tobytes() for x in (a, b)
            for i in range(0, x.shape[0] - BLK + 1, BLK)
            for j in range(0, x.shape[1] - BLK + 1, BLK)}


@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_gemm_locks_only_the_tiles_it_uploads_whole(tmp_path, monkeypatch,
                                                    case):
    kw = GEMM_CASES[case]
    fake = FakeLock(tiles=_tiles(**kw))
    got, stats = _gemm(tmp_path, "locked", fake, monkeypatch, **kw)
    want, _ = _gemm(tmp_path, "pageable", None, monkeypatch, **kw)
    assert got == want  # byte-equal with and without the functions
    assert not fake.errors and not fake.held  # all unlocked by destroy
    assert sorted(fake.unlocked) == sorted(a for a, _ in fake.locked)
    tile = BLK * BLK * 4
    assert all(n == tile for _, n in fake.locked)
    m, n = kw.get("m", M), kw.get("n", N)
    whole = (m // BLK) * (K // BLK) + (K // BLK) * (n // BLK)
    if kw.get("transfer_dtype") or kw.get("shard_reads"):
        assert stats["locks"] == 0  # cast, quantized, assembled: fresh
    elif case == "fp32_misses":
        # tiles miss again and again: each miss is given a locked buffer
        # an eviction released, or locks its new one at its upload, and
        # the buffers locked at once stay within the budget's
        assert stats["misses"] > whole and stats["used"] <= 6 * tile
        assert stats["locks"] + stats["recycles"] == stats["misses"]
        assert stats["recycles"] > stats["locks"]
        assert stats["locks"] - stats["unlocks"] <= 6
    else:
        # each whole tile's buffer is locked once, over both calls
        assert stats["locks"] == whole and stats["lock_fails"] == 0
        assert stats["recycles"] == 0


def test_gemm_with_a_refusing_lock_stays_right(tmp_path, monkeypatch):
    fake = FakeLock(refuse=True)
    got, stats = _gemm(tmp_path, "refused", fake, monkeypatch)
    want, _ = _gemm(tmp_path, "pageable", None, monkeypatch)
    assert got == want
    whole = 2 * (M // BLK) * (K // BLK)
    assert stats["locks"] == 0 and stats["lock_fails"] == whole
    assert fake.refused == whole and not fake.unlocked


DOCS, VOCAB, LABELS, TOPK, PANEL = 120, 301, 83, 5, 32


def _xml(tmp_path, tag, fake, monkeypatch, w_dtype=F32):
    from oocbench.entries.xml_rank import docs_csr
    _with_fake(monkeypatch, fake)
    cfg = {"docs": DOCS, "vocab": VOCAB, "nnz_per_doc_mean": 12,
           "nnz_per_doc_sigma": 1.0, "nnz_per_doc_max": 200,
           "zipf_exponent": 1.0}
    ia, ja, va = docs_csr(cfg, 2**31 + 7, "cpu")
    a = sps.csr_matrix((va.numpy(), ja.numpy(), ia.numpy()),
                       shape=(DOCS, VOCAB))
    w = np.random.default_rng(3).standard_normal(
        (LABELS, VOCAB)).astype(w_dtype)
    d = tmp_path / tag
    d.mkdir()
    prefix = str(d / "A")
    a.indptr.astype(np.int64).tofile(prefix + ".off")
    a.indices.astype(np.int64).tofile(prefix + ".col")
    a.data.astype(F32).tofile(prefix + ".csr")
    w.tofile(str(d / "W"))
    ctx = _ctx(d, max_nnzs=512)
    try:
        A = bt.CsrFlashMatrix.map_files(prefix, a.shape, ctx=ctx)
        W = bt.map_array(str(d / "W"), w.shape, w_dtype, ctx=ctx)
        outs = []
        for _ in range(2):
            s = bt.mem_array((DOCS, TOPK), F32, ctx=ctx)
            lab = bt.mem_array((DOCS, TOPK), np.int32, ctx=ctx)
            bt.xml_rank(A, W, TOPK, scores_out=s, labels_out=lab,
                        label_blk=PANEL, fused=True, ctx=ctx)
            outs.append((s.read_all().tobytes(), lab.read_all().tobytes()))
        stats = ctx.pin_cache_stats()
        gc.collect()
    finally:
        ctx.destroy()
    return outs, stats


@pytest.mark.parametrize("w_dtype", [F32, np.float64])
def test_xml_rank_locks_w_panels_it_uploads_as_they_stand(
        tmp_path, monkeypatch, w_dtype):
    """fp32 W's panels go up as pinned and are locked once each (A's
    blocks, banded into ELL on the host, never are); a float64 W is cast
    to fp32 first and stays pageable."""
    fake = FakeLock()
    got, stats = _xml(tmp_path, "locked", fake, monkeypatch, w_dtype)
    want, _ = _xml(tmp_path, "pageable", None, monkeypatch, w_dtype)
    assert got == want
    panels = -(-LABELS // PANEL)
    if w_dtype == F32:
        assert stats["locks"] == panels
        assert sorted(n for _, n in fake.locked) == sorted(
            min(PANEL, LABELS - b0) * VOCAB * 4
            for b0 in range(0, LABELS, PANEL))
    else:
        assert stats["locks"] == 0
    assert not fake.errors and not fake.held


def test_csrmm_locks_nothing(tmp_path, monkeypatch):
    """csrmm's uploads are ELL bands made on the host and B's panel:
    fresh arrays, never a cache buffer whole."""
    fake = FakeLock()
    _with_fake(monkeypatch, fake)
    rng = np.random.default_rng(9)
    a = sps.random(200, 150, density=0.05, format="csr", random_state=4,
                   dtype=F32)
    b = rng.standard_normal((150, 8)).astype(F32)
    d = tmp_path / "csr"
    d.mkdir()
    prefix = str(d / "A")
    a.indptr.astype(np.int64).tofile(prefix + ".off")
    a.indices.astype(np.int64).tofile(prefix + ".col")
    a.data.astype(F32).tofile(prefix + ".csr")
    b.tofile(str(d / "B"))
    ctx = _ctx(d, max_nnzs=256)
    try:
        A = bt.CsrFlashMatrix.map_files(prefix, a.shape, ctx=ctx)
        B = bt.map_array(str(d / "B"), b.shape, F32, ctx=ctx)
        C = bt.mem_array((200, 8), F32, ctx=ctx)
        bt.csrmm(A, B, C, ctx=ctx)
        np.testing.assert_allclose(C.read_all(), a @ b, rtol=1e-4,
                                   atol=1e-5)
        assert ctx.pin_cache_stats()["locks"] == 0
    finally:
        ctx.destroy()
    assert not fake.locked and not fake.errors


def test_gemm_drops_each_tile_after_its_last_read(tmp_path, monkeypatch):
    """The device LRU forgets each operand tile after the last step that
    reads it, so faster uploads do not leave a call holding tiles it has
    done with while finished C blocks wait for the writer: the LRU ends
    each call empty, never held every tile at once, and no tile went up
    twice."""
    gemm_mod = importlib.import_module("bof_tpu_torch.ops.gemm")
    caches = []

    class Recording(gemm_mod.HbmCache):
        def __init__(self, budget_bytes):
            super().__init__(budget_bytes)
            self.peak = 0
            caches.append(self)

        def put(self, key, arr, nbytes):
            out = super().put(key, arr, nbytes)
            self.peak = max(self.peak, self._used)
            return out

    monkeypatch.setattr(gemm_mod, "HbmCache", Recording)
    puts = METRICS.get("hbm.miss")
    _gemm(tmp_path, "drop", None, monkeypatch, calls=1)
    tiles = (M // BLK) * (K // BLK) + (K // BLK) * (N // BLK)
    assert METRICS.get("hbm.miss") - puts == tiles
    (hbm,) = caches
    assert hbm._used == 0 and not hbm._map
    assert hbm.peak < tiles * BLK * BLK * 4
