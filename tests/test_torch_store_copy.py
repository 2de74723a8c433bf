"""`MemStore`'s copies (`io/store.py`): one strided copy an access, cut
over the store's persistent copy threads when the copy is large.

Every case runs the same accesses on a `MemStore` and on a row-by-row
reference (the store's first design: one slice a run, zeros past EOF)
and holds the store's bytes, each read and the `store.split_*` counters
to it.  Small cases lower the split's thresholds; `BOF_HOST_THREADS`
fixes the number of ranges, so the split runs on any host.
"""
import threading

import numpy as np
import pytest

from bof_tpu_torch.io import store as S
from bof_tpu_torch.io.store import MemStore
from bof_tpu_torch.io.stride import StrideInfo
from bof_tpu_torch.utils import METRICS

MIB = 1 << 20


def _ref_write(data, offset, si, src):
    end = offset + si.file_extent
    if end > len(data):
        data = np.concatenate([data, np.zeros(end - len(data), np.uint8)])
    for i in range(si.n_strides):
        fo, bo = offset + i * si.stride, i * si.len_per_stride
        data[fo:fo + si.len_per_stride] = src[bo:bo + si.len_per_stride]
    return data


def _ref_read(data, offset, si):
    out = np.full(si.nbytes, 0xAB, np.uint8)
    for i in range(si.n_strides):
        fo, bo = offset + i * si.stride, i * si.len_per_stride
        avail = max(0, min(si.len_per_stride, len(data) - fo))
        out[bo:bo + avail] = data[fo:fo + avail]
        out[bo + avail:bo + si.len_per_stride] = 0
    return out


def _split_threads():
    return {t.name for t in threading.enumerate()
            if t.name.startswith("store-copy")}


# (op, offset, (stride, n_strides, len_per_stride), split expected)
CASES = {
    "strided_inline": dict(size=4096, ops=[
        ("w", 8, (48, 7, 20), False), ("r", 0, (48, 9, 20), False)]),
    "contiguous_inline": dict(size=4096, ops=[
        ("w", 100, (1000, 1, 1000), False), ("r", 90, (1100, 1, 1100),
                                             False)]),
    "strided_split": dict(size=4096, threads=4, small=True, ops=[
        ("w", 8, (48, 12, 20), True), ("r", 0, (48, 12, 20), False)]),
    "contiguous_split": dict(size=4096, threads=4, small=True, ops=[
        ("w", 3, (1001, 1, 1001), True), ("r", 0, (1004, 1, 1004), False)]),
    "odd_rows_over_3": dict(size=8192, threads=3, small=True, ops=[
        ("w", 5, (96, 10, 64), True), ("w", 7, (96, 11, 17), True),
        ("r", 0, (96, 11, 80), False)]),
    "odd_rows_over_4": dict(size=8192, threads=4, small=True, ops=[
        ("w", 0, (40, 13, 33), True), ("r", 0, (40, 13, 40), False)]),
    "fewer_rows_than_threads": dict(size=4096, threads=8, small=True, ops=[
        ("w", 0, (512, 3, 100), True), ("r", 0, (512, 3, 100), False)]),
    "one_run_cut_by_bytes": dict(size=4096, threads=8, small=True, ops=[
        ("w", 0, (512, 1, 100), True)]),
    "inline_below_threshold": dict(size=4096, threads=4, small=True, ops=[
        ("w", 0, (48, 3, 20), False)]),
    "growth_past_the_end": dict(size=256, threads=4, small=True, ops=[
        ("w", 200, (64, 9, 48), True), ("w", 2000, (100, 1, 100), True),
        ("r", 0, (64, 40, 64), False)]),
    "growth_inline": dict(size=0, ops=[
        ("w", 10, (32, 5, 16), False), ("r", 0, (32, 6, 32), False)]),
    "eof_zero_fill": dict(size=1000, threads=4, small=True, ops=[
        ("w", 0, (1000, 1, 1000), True),
        ("r", 500, (100, 9, 64), False),   # a run cut by EOF, runs past it
        ("r", 950, (100, 1, 100), False),  # a contiguous read cut by EOF
        ("r", 2000, (64, 4, 32), False),   # wholly past EOF
        ("r", 936, (64, 3, 64), False)]),  # the first run ends at EOF
    "empty_accesses": dict(size=64, threads=4, small=True, ops=[
        ("w", 10, (0, 1, 0), False), ("w", 10, (16, 0, 8), False),
        ("r", 10, (0, 1, 0), False), ("r", 10, (16, 0, 8), False)]),
    "threshold_16MiB": dict(size=0, threads=4, ops=[
        ("w", 0, (64 << 10, 512, 32 << 10), True),          # 16 MiB: split
        ("w", 32 << 10, (64 << 10, 511, 32 << 10), False),  # under it
        ("w", 32 * MIB, (16 * MIB, 1, 16 * MIB), True),     # contiguous
        ("r", 0, (64 << 10, 512, 64 << 10), False)]),
    "one_thread_override": dict(size=0, threads=1, ops=[
        ("w", 0, (64 << 10, 512, 32 << 10), False)]),
    "overlapping_strides": dict(size=4096, threads=4, small=True,
                                raises=(ValueError, "overlapping"), ops=[
        ("w", 0, (16, 8, 20), False)]),
    "a_worker_raises": dict(size=4096, threads=4, small=True,
                            raises=(RuntimeError, "worker's piece"), ops=[
        ("w", 0, (48, 12, 20), True)]),
    "the_threads_persist": dict(size=4096, threads=4, small=True,
                                persist=True, ops=[
        ("w", 0, (48, 12, 20), True), ("w", 4, (48, 12, 20), True),
        ("w", 0, (1001, 1, 1001), True)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_memstore_copies_as_the_row_by_row_reference(monkeypatch, case):
    spec = CASES[case]
    if spec.get("threads"):
        monkeypatch.setenv("BOF_HOST_THREADS", str(spec["threads"]))
    if spec.get("small"):
        monkeypatch.setattr(S, "SPLIT_MIN_BYTES", 64)
        monkeypatch.setattr(S, "SPLIT_MIN_PER", 16)
    rng = np.random.default_rng(sum(map(ord, case)))
    init = rng.integers(0, 256, spec["size"], dtype=np.uint8)
    store, ref = MemStore(spec["size"]), init.copy()
    store._data[:] = init
    if "raises" in spec:
        err, match = spec["raises"]
        if err is RuntimeError:  # a copy thread's piece raises
            assign, raised = S._assign, threading.Event()

            def failing(dst, src, a, b):
                if threading.current_thread().name.startswith("store-copy"):
                    raised.set()
                    raise RuntimeError(f"a worker's piece at {a}")
                raised.wait(timeout=30)  # the caller leaves them pieces
                assign(dst, src, a, b)
            monkeypatch.setattr(S, "_assign", failing)
        _, off, si, _ = spec["ops"][0]
        si = StrideInfo(*si)
        with pytest.raises(err, match=match):
            store.write(off, si, rng.integers(0, 256, si.nbytes,
                                              dtype=np.uint8))
        return
    writes0 = METRICS.get("store.split_writes")
    bytes0 = METRICS.get("store.split_bytes")
    want_writes = want_bytes = 0
    threads = []
    for op, off, si, split in spec["ops"]:
        si = StrideInfo(*si)
        if op == "w":
            src = rng.integers(0, 256, si.nbytes + 7, dtype=np.uint8)
            store.write(off, si, src).wait()
            ref = _ref_write(ref, off, si, src)
            want_writes += split
            want_bytes += split * si.nbytes
            threads.append(_split_threads())
        else:
            out = np.full(si.nbytes, 0xAB, np.uint8)
            store.read(off, si, out).wait()
            np.testing.assert_array_equal(out, _ref_read(ref, off, si))
        assert store.size() == len(ref)
        np.testing.assert_array_equal(store._data, ref)
    assert METRICS.get("store.split_writes") - writes0 == want_writes
    assert METRICS.get("store.split_bytes") - bytes0 == want_bytes
    if spec.get("persist"):  # later writes reuse the first one's threads
        assert threads[0] and all(threads[0] <= t for t in threads)


def test_gemm_books_c_bytes_on_its_write_span_and_the_split(tmp_path,
                                                            monkeypatch):
    """gemm's writer books C's bytes on `gemm.write`; with every write
    split, `store.split_bytes` counts the same bytes."""
    import bof_tpu_torch as bt
    from bof_tpu_torch.ops import device as dev

    monkeypatch.setenv("BOF_HOST_THREADS", "3")
    monkeypatch.setattr(S, "SPLIT_MIN_BYTES", 1)
    monkeypatch.setattr(S, "SPLIT_MIN_PER", 1)
    monkeypatch.setattr(dev, "RING_SLOT_BYTES", 5 * 16 * 4)
    m, n, k = 37, 29, 41
    rng = np.random.default_rng(3)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ctx = bt.FlashContext(bt.FlashConfig(
        device="cpu", scratch_dir=str(tmp_path), n_io_threads=2,
        program_budget=64 << 20))
    try:
        A = bt.mem_array((m, k), np.float32, "R", data=a, ctx=ctx)
        B = bt.mem_array((k, n), np.float32, "R", data=b, ctx=ctx)
        C = bt.mem_array((m, n), np.float32, "R", ctx=ctx)
        before = {key: METRICS.get(key) for key in
                  ("gemm.write_bytes", "store.split_bytes")}
        bt.gemm(A, B, C, blk=16, ctx=ctx)
        moved = {key: METRICS.get(key) - v for key, v in before.items()}
        got = C.read_all()
    finally:
        ctx.destroy()
    assert moved["gemm.write_bytes"] == m * n * 4
    assert moved["store.split_bytes"] == m * n * 4
    np.testing.assert_allclose(got, a.astype(np.float64) @ b, rtol=2e-4,
                               atol=2e-4)


def test_concurrent_split_writes_keep_every_byte(monkeypatch):
    """Writers on 12 threads, each split 16 ways over the one copy pool
    (more ranges than cores, the interpreter switching often): every
    store holds every writer's bytes and the counters every split."""
    import sys

    monkeypatch.setenv("BOF_HOST_THREADS", "16")
    monkeypatch.setattr(S, "SPLIT_MIN_BYTES", 64)
    monkeypatch.setattr(S, "SPLIT_MIN_PER", 16)
    si = StrideInfo(96, 40, 64)
    shared, own = MemStore(0), [MemStore(0) for _ in range(12)]
    srcs = [np.random.default_rng(i).integers(0, 256, (25, si.nbytes),
                                              dtype=np.uint8)
            for i in range(12)]
    writes0 = METRICS.get("store.split_writes")
    errs = []

    def writer(w):
        try:
            for r in range(25):  # w's own rows of `shared`, all of `own`
                shared.write((r * 12 + w) * si.file_extent, si,
                             srcs[w][r]).wait()
                own[w].write(0, si, srcs[w][r]).wait()
        except BaseException as e:  # surfaced below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=writer, args=(w,)) for w in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts) and not errs
    ref = np.zeros(0, np.uint8)
    for r in range(25):
        for w in range(12):
            ref = _ref_write(ref, (r * 12 + w) * si.file_extent, si,
                             srcs[w][r])
    np.testing.assert_array_equal(shared._data, ref)
    for w in range(12):
        np.testing.assert_array_equal(
            own[w]._data, _ref_write(np.zeros(0, np.uint8), 0, si,
                                     srcs[w][24]))
    assert METRICS.get("store.split_writes") - writes0 == 2 * 12 * 25
