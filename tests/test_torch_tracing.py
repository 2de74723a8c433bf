"""The port's spans and the native pin cache's read-bytes counter, on the
CPU (the kernels' plain versions).

A span (`METRICS.span`, utils/metrics.py) books its stage's seconds and
bytes as the counters the stages booked before spans existed, and only
while spans are switched on (`utils/profiling.set_spans`, which
`profiling.trace` sets for its region) records a torch.profiler range on
its own thread.  gemm, csrmm and csrgemv run their stages in spans on the
threads of their pipelines, xml_rank's fused path on the caller's; the native cache counts the bytes of the pins
that missed (`read_bytes`), which `FlashContext.pin_cache_stats()`
returns."""
import gc
import json
import os
import queue

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import bof_tpu_torch
import bof_tpu_torch.sparse
from bof_tpu_torch.core.pipeline import TicketWindow, queue_items, queue_put
from bof_tpu_torch.ops import device as dev
from bof_tpu_torch.utils import METRICS, profiling
from bof_tpu_torch.utils.metrics import Metrics

F32 = np.float32
BLK = 32


def _ctx(tmp_path, **kw):
    cfg = dict(device="cpu", scratch_dir=str(tmp_path / "scratch"),
               program_budget=64 << 20, gemm_blk_size=BLK, max_nnzs=2048,
               csrmm_cblk_size=16)
    cfg.update(kw)
    return bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(**cfg))


def run_gemm(tmp_path, ctx):
    """C = A B over files, every tile whole (64 x 96 x 64 at blk 32)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 96)).astype(F32)
    b = rng.standard_normal((96, 64)).astype(F32)
    arrs = []
    for name, x in (("A", a), ("B", b), ("C", np.zeros((64, 64), F32))):
        path = str(tmp_path / name)
        x.tofile(path)
        arrs.append(bof_tpu_torch.map_array(path, x.shape, F32, ctx=ctx))
    bof_tpu_torch.gemm(*arrs, ctx=ctx)
    got = np.fromfile(str(tmp_path / "C"), F32).reshape(64, 64)
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)


def _csr(tmp_path, ctx):
    a = sps.random(300, 120, density=0.05, format="csr", dtype=F32,
                   random_state=np.random.RandomState(11))
    a.sort_indices()
    prefix = str(tmp_path / "A")
    a.indptr.astype(np.int64).tofile(prefix + ".off")
    a.indices.astype(np.int64).tofile(prefix + ".col")
    a.data.astype(F32).tofile(prefix + ".csr")
    return a, bof_tpu_torch.sparse.CsrFlashMatrix.map_files(
        prefix, a.shape, ctx=ctx)


def run_csrmm(tmp_path, ctx):
    """C = A B, A 300 x 120 CSR in row blocks of 2048 nonzeros, B 120 x 16
    (one column panel, so one set of pipeline threads)."""
    a, a_f = _csr(tmp_path, ctx)
    b = np.random.default_rng(2).standard_normal((120, 16)).astype(F32)
    b.tofile(str(tmp_path / "B"))
    np.zeros((300, 16), F32).tofile(str(tmp_path / "C"))
    b_f = bof_tpu_torch.map_array(str(tmp_path / "B"), b.shape, F32,
                                  ctx=ctx)
    c_f = bof_tpu_torch.map_array(str(tmp_path / "C"), (300, 16), F32,
                                  ctx=ctx)
    bof_tpu_torch.sparse.csrmm(a_f, b_f, c_f, ctx=ctx)
    got = np.fromfile(str(tmp_path / "C"), F32).reshape(300, 16)
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)


def run_csrgemv(tmp_path, ctx):
    a, a_f = _csr(tmp_path, ctx)
    x = np.random.default_rng(3).standard_normal(120).astype(F32)
    y = bof_tpu_torch.sparse.csrgemv(a_f, x, ctx=ctx)
    np.testing.assert_allclose(y, a @ x, rtol=1e-4, atol=1e-4)


def run_xml_rank(tmp_path, ctx):
    """The fused top-5 of A W^T, W 37 x 120 in label panels of 16."""
    a, a_f = _csr(tmp_path, ctx)
    w = np.random.default_rng(4).standard_normal((37, 120)).astype(F32)
    w.tofile(str(tmp_path / "W"))
    w_f = bof_tpu_torch.map_array(str(tmp_path / "W"), w.shape, F32,
                                  ctx=ctx)
    s, _ = bof_tpu_torch.xml_rank(a_f, w_f, 5, label_blk=16, fused=True,
                                  ctx=ctx)
    want = -np.sort(-(a @ w.T), axis=1)[:, :5]
    np.testing.assert_allclose(s.read_all(), want, rtol=1e-4, atol=1e-4)


RUN = {"gemm": run_gemm, "csrmm": run_csrmm, "csrgemv": run_csrgemv,
       "xml_rank": run_xml_rank}
# the counters each entry's stages booked before they ran in spans
BOOKED = {
    "gemm": ("disk_wait_s", "prep_s", "h2d_s", "h2d_bytes", "tile_wait_s",
             "accum_wait_s", "d2h_s", "d2h_bytes", "write_wait_s"),
    "csrmm": ("disk_wait_s", "prep_s", "h2d_s", "h2d_bytes", "dispatch_s",
              "accum_wait_s", "d2h_s", "d2h_bytes", "write_wait_s"),
    "csrgemv": ("disk_wait_s", "prep_s", "h2d_s", "h2d_bytes",
                "dispatch_s", "d2h_s"),
    "xml_rank": ("w_wait_s", "w_h2d_s", "disk_wait_s", "prep_s", "h2d_s",
                 "h2d_bytes", "dispatch_s", "d2h_s", "d2h_bytes",
                 "merge_s"),
}


def _run(entry, tmp_path, **kw):
    ctx = _ctx(tmp_path, **kw)
    try:
        before = METRICS.snapshot()
        RUN[entry](tmp_path, ctx)
        after = METRICS.snapshot()
    finally:
        ctx.destroy()
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


@pytest.mark.parametrize("entry", sorted(RUN))
def test_entries_book_their_stage_counters(tmp_path, entry, monkeypatch):
    """Each stage books the counter it booked before spans, and the call
    its entry span `<entry>_s`; `<entry>.h2d_bytes` counts every byte
    handed to the uploads (csrmm's B panel and csrgemv's x included)."""
    uploaded = []
    to_device = dev.to_device

    def counting(x, device):
        uploaded.append(np.asarray(x).nbytes)
        return to_device(x, device)
    monkeypatch.setattr(dev, "to_device", counting)
    booked = _run(entry, tmp_path)
    for key in BOOKED[entry]:
        assert booked.get(f"{entry}.{key}", 0) > 0, key
    assert booked[f"{entry}_s"] > 0
    assert booked[f"{entry}.h2d_bytes"] == sum(uploaded)
    for gone in ("gemm.ms", "csrmm.ms", "pincache.native",
                 "pincache.python"):
        assert gone not in booked


@pytest.mark.parametrize("entry", sorted(RUN))
def test_spans_off_never_enter_record_function(tmp_path, entry,
                                               monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered with spans off")
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    assert profiling.spans_on is False
    assert _run(entry, tmp_path)[f"{entry}_s"] > 0


def _trace_spans(tmp_path, entry):
    """{span name: [(tid, start, end)]} of one traced call of `entry`."""
    log_dir = str(tmp_path / "prof")
    ctx = _ctx(tmp_path)
    try:
        with profiling.trace("t", log_dir):
            RUN[entry](tmp_path, ctx)
    finally:
        ctx.destroy()
    assert profiling.spans_on is False  # restored after the region
    with open(os.path.join(log_dir, f"t.{os.getpid()}.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(
                (e["tid"], e["ts"], e["ts"] + e["dur"]))
    return spans


def _tid(spans, name):
    tids = {t for t, _, _ in spans[name]}
    assert len(tids) == 1, (name, tids)
    return tids.pop()


def _inside(inner, outer):
    return all(any(t == u and s0 <= s and e <= e0 for u, s0, e0 in outer)
               for t, s, e in inner)


# the threads of each entry and the spans each runs, first the caller's
THREADS = {
    "gemm": (("gemm", "gemm.tile_wait", "gemm.accum"),
             ("gemm.disk_wait", "gemm.prep", "gemm.h2d"),
             ("gemm.accum_wait", "gemm.d2h", "gemm.write",
              "gemm.write_wait")),
    "csrmm": (("csrmm",),
              ("csrmm.disk_wait", "csrmm.prep"),
              ("csrmm.dispatch",),
              ("csrmm.accum_wait", "csrmm.d2h", "csrmm.write")),
    "csrgemv": (("csrgemv", "csrgemv.disk_wait", "csrgemv.prep",
                 "csrgemv.h2d", "csrgemv.dispatch", "csrgemv.d2h"),),
    "xml_rank": (("xml_rank", "xml_rank.w_wait", "xml_rank.w_h2d",
                  "xml_rank.disk_wait", "xml_rank.prep", "xml_rank.h2d",
                  "xml_rank.dispatch", "xml_rank.d2h", "xml_rank.merge"),),
}


@pytest.mark.parametrize("entry", sorted(RUN))
def test_spans_on_record_each_stage_on_its_own_thread(tmp_path, entry):
    spans = _trace_spans(tmp_path, entry)
    tids = []
    for names in THREADS[entry]:
        tid = _tid(spans, names[0])
        for name in names[1:]:
            assert _tid(spans, name) == tid, name
        tids.append(tid)
    assert len(set(tids)) == len(tids)
    (_, c0, c1), = call = spans[entry]  # one call, every stage inside it
    for name, found in spans.items():
        if name not in ("t", entry):
            assert all(c0 <= s and e <= c1 for _, s, e in found), name
    if entry == "csrmm":
        # each band's upload inside the uploader's dispatch; the B panel's
        # on the calling thread, in the call
        uploader = tids[2]
        bands = [x for x in spans["csrmm.h2d"] if x[0] == uploader]
        panels = [x for x in spans["csrmm.h2d"] if x[0] == tids[0]]
        assert bands and _inside(bands, spans["csrmm.dispatch"])
        assert len(panels) == 1 and _inside(panels, call)
        assert len(bands) + len(panels) == len(spans["csrmm.h2d"])
    if entry in ("gemm", "csrmm"):
        # the hand-offs: a stage waiting on another, on the stage's thread
        waits = {t for t, _, _ in spans[f"{entry}.queue_wait"]}
        assert waits <= set(tids) and len(waits) >= 2


@pytest.mark.parametrize("backend", ["python", "native"])
def test_pin_cache_stats(tmp_path, backend):
    """The public accessor of the native cache's counters: None where pins
    take the Python TileCache; else its stats(), whose read_bytes after a
    gemm over whole tiles is its misses times a tile's bytes."""
    ctx = _ctx(tmp_path, tile_cache_backend=backend)
    try:
        run_gemm(tmp_path, ctx)
        stats = ctx.pin_cache_stats()
    finally:
        ctx.destroy()
    if backend == "python":
        assert stats is None
        return
    assert stats["misses"] > 0
    assert stats["read_bytes"] == stats["misses"] * BLK * BLK * 4


def test_native_read_bytes_are_the_bytes_of_the_pins_that_missed(tmp_path):
    """On a file whose budget forces evictions, pins of three sizes hit
    and miss; read_bytes grows by a pin's bytes exactly when it misses."""
    from bof_tpu_torch.io.native import NativeFileStore, load_library
    from bof_tpu_torch.io.native_cache import NativeTileCache
    from bof_tpu_torch.io.stride import StrideInfo
    assert load_library() is not None
    path = str(tmp_path / "nc.bin")
    np.arange(1 << 16, dtype=np.uint32).tofile(path)
    store = NativeFileStore(path, n_threads=2)
    cache = NativeTileCache(48 << 10)
    sizes = {0: 8 << 10, 1: 16 << 10, 2: 32 << 10}
    want = missed = hit = 0
    try:
        for tile in (0, 1, 0, 1, 2, 0, 2, 1, 1):
            before = cache.stats()
            key = cache.pin_read(store, tile * (64 << 10),
                                 StrideInfo.contiguous(sizes[tile]))
            cache.wait_ready(key)
            cache.unpin(key)
            after = cache.stats()
            if after["misses"] > before["misses"]:
                missed += 1
                want += sizes[tile]
            else:
                hit += 1
            assert after["read_bytes"] == want
        assert missed and hit and cache.stats()["evictions"]
    finally:
        gc.collect()
        cache.close()
        store.close()


def test_span_books_seconds_and_bytes_and_decorates():
    m = Metrics()
    with m.span("stage", 10) as sp:
        sp.nbytes += 5
    assert m.get("stage_s") == sp.seconds > 0
    assert m.get("stage_bytes") == 15
    with m.span("quiet"):
        pass
    assert "quiet_bytes" not in m.snapshot()

    @m.span("call")
    def f(x):
        return x + 1
    assert f(1) == 2 and f(2) == 3
    assert m.get("call_s") > 0
    with pytest.raises(ValueError):
        with m.span("failed"):
            raise ValueError("a stage failed")
    assert m.get("failed_s") > 0


def test_annotate_books_no_counters_and_set_spans_returns_the_last():
    before = METRICS.snapshot()
    with profiling.annotate("region"):
        pass
    assert METRICS.snapshot() == before
    assert profiling.set_spans(True) is False
    try:
        assert profiling.spans_on is True
    finally:
        assert profiling.set_spans(False) is True


def test_hand_offs_book_their_waits():
    """A pipeline queue's gets and puts, and a ticket window's waits, run
    inside the span their caller names."""
    m0 = METRICS.snapshot()
    q = queue.Queue(maxsize=4)
    for item in (1, 2, None):
        assert queue_put(q, item, [], "test_tracing.queue_wait")
    assert list(queue_items(q, [], "test_tracing.queue_wait")) == [1, 2]

    class Ticket:
        def wait(self):
            pass
    window = TicketWindow(depth=1, span="test_tracing.write_wait")
    window.extend([Ticket(), Ticket()])
    window.wait_all()
    m1 = METRICS.snapshot()
    for name in ("test_tracing.queue_wait_s", "test_tracing.write_wait_s"):
        assert m1[name] - m0.get(name, 0.0) > 0, name
