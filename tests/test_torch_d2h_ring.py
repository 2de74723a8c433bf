"""The download ring (`ops/device.py`: `D2HRing`, `Finished`) and the gemm
writers that take finished C blocks through it, on the CPU device (the
same schedule as on a card, with ordinary host slots and no stream).

The writers are held to the download they replaced: one `from_device` of
the whole finished block, handed to the same write as one run
(`_whole_block`).  Slots of a few rows (`SLOT`) split every block into
several runs and a short last one, so each case crosses slot reuse.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import bof_tpu_torch as bt
from bof_tpu_torch.io.store import MemStore, Ticket
from bof_tpu_torch.ops import device as dev
from bof_tpu_torch.utils import METRICS

SLOT = 320  # bytes: 5 fp32 rows of a 16-wide block, 2 fp64, 10 bf16
BLK = 16


def _whole_block(self, fin, prepare, rows, cols, consume, name):
    """The writers' download before the ring: the whole finished block
    through one `from_device`, written as one run."""
    block, fin.block = fin.block, None
    ticket = consume(0, dev.from_device(prepare(block))[:rows, :cols])
    if ticket is not None:
        ticket.wait()
    return 0.0


@pytest.fixture
def small_slots(monkeypatch):
    monkeypatch.setattr(dev, "RING_SLOT_BYTES", SLOT)


def _ctx(tmp_path, **kw):
    cfg = bt.FlashConfig(device="cpu", scratch_dir=str(tmp_path / "scratch"),
                         n_io_threads=2, program_budget=64 << 20, **kw)
    return bt.FlashContext(cfg)


def _make_c(ctx, path, shape, dtype, order, layout, c0):
    """C as a file: flat, ld-padded by 3 or tile-major (tile BLK)."""
    if layout == "tiled":
        c = bt.map_tiled_array(path, shape, dtype, order, tile=BLK,
                               create=True, ctx=ctx)
    else:
        width = shape[1] if order == "R" else shape[0]
        ld = width + 3 if layout == "ld" else None
        c = bt.map_array(path, shape, dtype, order, create=True, ctx=ctx,
                         ld=ld)
    c.write_block(0, c0)
    return c


GEMM_CASES = {
    "R": dict(order="R"),
    "C": dict(order="C"),
    "R_ld": dict(order="R", layout="ld"),
    "C_ld": dict(order="C", layout="ld"),
    "R_tiled": dict(order="R", layout="tiled"),
    "C_tiled": dict(order="C", layout="tiled"),
    "R_whole_blocks": dict(order="R", m=32, n=48),
    "R_beta": dict(order="R", beta=0.75),
    "R_f64": dict(order="R", dtype=np.float64),
    "C_f64_beta": dict(order="C", dtype=np.float64, beta=0.5),
    "R_c_bf16": dict(order="R", c_transfer_dtype="bfloat16"),
    "C_c_bf16_tiled": dict(order="C", layout="tiled",
                           c_transfer_dtype="bfloat16"),
    "R_journal": dict(order="R", journal=True),
    "C_ld_journal": dict(order="C", layout="ld", journal=True),
}


def _gemm_c_bytes(tmp_path, tag, *, order, layout="flat", m=37, n=29, k=41,
                  dtype=np.float32, beta=0.0, journal=False, **cfg_kw):
    """One gemm into a file-backed C (A, B in DRAM); C's file bytes."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((m, k)).astype(dtype)
    b = rng.standard_normal((k, n)).astype(dtype)
    c0 = rng.standard_normal((m, n)).astype(dtype)
    d = tmp_path / tag
    d.mkdir()
    ctx = _ctx(d, **cfg_kw)
    try:
        A = bt.mem_array((m, k), dtype, order, data=a, ctx=ctx)
        B = bt.mem_array((k, n), dtype, order, data=b, ctx=ctx)
        path = str(d / "C.bin")
        C = _make_c(ctx, path, (m, n), dtype, order, layout, c0)
        journal_path = str(d / "journal") if journal else None
        bt.gemm(A, B, C, alpha=1.25, beta=beta, blk=BLK, ctx=ctx,
                resume_journal=journal_path)
        got = C.read_all()
        assert journal_path is None or not os.path.exists(journal_path)
    finally:
        ctx.destroy()
    want = 1.25 * (a.astype(np.float64) @ b) + beta * c0
    tol = 1e-2 if cfg_kw.get("c_transfer_dtype") else 2e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_gemm_writes_the_bytes_of_a_whole_block_download(
        tmp_path, monkeypatch, small_slots, case):
    """Every C layout, edge block, dtype, transfer mode and the journal:
    C's file bytes through the ring's runs equal those of the whole-block
    download, and the ring counts each byte it brought down."""
    kw = GEMM_CASES[case]
    before = METRICS.get("d2h.ring_bytes")
    got = _gemm_c_bytes(tmp_path, "ring", **kw)
    moved = METRICS.get("d2h.ring_bytes") - before
    monkeypatch.setattr(dev.D2HRing, "download", _whole_block)
    want = _gemm_c_bytes(tmp_path, "whole", **kw)
    assert got == want
    m, n = kw.get("m", 37), kw.get("n", 29)
    isz = 2 if kw.get("c_transfer_dtype") else np.dtype(
        kw.get("dtype", np.float32)).itemsize
    # a tile-major C takes whole padded tiles; a flat one the real extent
    n_el = (-(-m // BLK) * -(-n // BLK) * BLK * BLK
            if kw.get("layout") == "tiled" else m * n)
    assert moved == n_el * isz


SHARDED_CASES = {
    "R": dict(order="R"),
    "C": dict(order="C"),
    "R_tiled": dict(order="R", layout="tiled"),
    "C_f64": dict(order="C", dtype=np.float64),
    "R_shard_reads": dict(order="R", shard_reads=True),
    "C_shard_reads_ld": dict(order="C", layout="ld", shard_reads=True),
}


def _sharded_c_bytes(tmp_path, tag, *, order, layout="flat",
                     dtype=np.float32, shard_reads=False):
    from torch_dist_pool import one_rank_world

    from bof_tpu_torch.parallel import gemm_sharded
    from bof_tpu_torch.parallel import mesh as meshmod
    m, n, k = 37, 29, 41
    rng = np.random.default_rng(11)
    a = rng.standard_normal((m, k)).astype(dtype)
    b = rng.standard_normal((k, n)).astype(dtype)
    d = tmp_path / tag
    d.mkdir()
    ctx = _ctx(d)
    meshmod._FORCE_SHARDED_READS = shard_reads
    try:
        A = bt.mem_array((m, k), dtype, order, data=a, ctx=ctx)
        B = bt.mem_array((k, n), dtype, order, data=b, ctx=ctx)
        path = str(d / "C.bin")
        C = _make_c(ctx, path, (m, n), dtype, order, layout,
                    np.zeros((m, n), dtype))
        with one_rank_world() as mesh:
            gemm_sharded(A, B, C, alpha=0.5, blk=BLK, mesh=mesh, ctx=ctx)
        got = C.read_all()
    finally:
        meshmod._FORCE_SHARDED_READS = False
        ctx.destroy()
    np.testing.assert_allclose(got, 0.5 * (a.astype(np.float64) @ b),
                               rtol=2e-4, atol=2e-4)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_gemm_sharded_writes_the_bytes_of_a_whole_block_download(
        tmp_path, monkeypatch, small_slots, case):
    """gemm_sharded's writer (a world of one gloo rank; `shard_reads`:
    the several-rank branch's shard write-back) through the ring's runs
    gives C's bytes of the whole-block download."""
    got = _sharded_c_bytes(tmp_path, "ring", **SHARDED_CASES[case])
    monkeypatch.setattr(dev.D2HRing, "download", _whole_block)
    want = _sharded_c_bytes(tmp_path, "whole", **SHARDED_CASES[case])
    assert got == want


class _LateStore:
    """C's store with every write done late: its bytes are read from the
    caller's buffer only after `delay` seconds, on a thread of its own,
    as a queued disk write reads them; `fail_at` makes that write fail."""

    def __init__(self, inner, delay, fail_at=None):
        self._inner, self._delay, self._fail_at = inner, delay, fail_at
        self.writes = 0

    def write(self, off, sinfo, src):
        self.writes += 1
        ticket = Ticket(src)
        fail = self.writes == self._fail_at

        def later():
            time.sleep(self._delay)
            if fail:
                ticket._complete("injected write failure")
                return
            self._inner.write(off, sinfo, src).wait()
            ticket._complete()

        threading.Thread(target=later, daemon=True).start()
        return ticket

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _late_gemm(tmp_path, tag, delay, fail_at=None, journal=False):
    m, n, k = 40, 24, 20
    rng = np.random.default_rng(3)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    d = tmp_path / tag
    d.mkdir()
    ctx = _ctx(d)
    try:
        A = bt.mem_array((m, k), np.float32, "R", data=a, ctx=ctx)
        B = bt.mem_array((k, n), np.float32, "R", data=b, ctx=ctx)
        inner = MemStore(m * n * 4)
        C = bt.FlashArray(_LateStore(inner, delay, fail_at), (m, n),
                          np.float32, "R", ctx=ctx)
        bt.gemm(A, B, C, blk=BLK, ctx=ctx,
                resume_journal=str(d / "journal") if journal else None)
        return inner._data.tobytes(), a.astype(np.float64) @ b
    finally:
        ctx.destroy()


@pytest.mark.parametrize("journal", [False, True])
def test_a_slot_waits_for_its_late_write(tmp_path, monkeypatch,
                                         small_slots, journal):
    """A store whose writes read their buffer 20 ms late: each slot is
    reused only once its write is done (the bytes would otherwise be a
    later run's), and those waits are booked to gemm.d2h_slot_wait."""
    before = METRICS.get("gemm.d2h_slot_wait_s")
    got, want = _late_gemm(tmp_path, "ring", 0.02, journal=journal)
    waited = METRICS.get("gemm.d2h_slot_wait_s") - before
    np.testing.assert_allclose(np.frombuffer(got, np.float32).reshape(
        want.shape), want, rtol=2e-4, atol=2e-4)
    monkeypatch.setattr(dev.D2HRing, "download", _whole_block)
    assert got == _late_gemm(tmp_path, "whole", 0.0)[0]
    if not journal:  # the journal waits on every write itself
        assert waited > 0.01


def _bounded(fn, timeout=120.0):
    """Run `fn` on a thread; its exception (None if it returned), after
    asserting that it ended within `timeout` seconds."""
    box = []

    def run():
        try:
            fn()
        except BaseException as e:  # handed to the test
            box.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), "the pipeline hung"
    return box[0] if box else None


class _FailingStore(MemStore):
    """A DRAM store whose third write raises when it is submitted."""

    def __init__(self, nbytes):
        super().__init__(nbytes)
        self.writes = 0

    def write(self, off, sinfo, src):
        self.writes += 1
        if self.writes == 3:
            raise IOError("injected submit failure")
        return super().write(off, sinfo, src)


@pytest.mark.parametrize("where", ["prepare", "submit", "late_write"])
def test_a_download_failure_reaches_the_caller_without_a_hang(
        tmp_path, monkeypatch, small_slots, where):
    """A failure inside the download (the cast on the copy stream, a write
    that fails to submit, a write that fails after the ring moved on)
    reaches the pipeline's error list and gemm's caller, and nothing
    hangs."""
    if where == "late_write":
        err = _bounded(lambda: _late_gemm(tmp_path, "x", 0.01, fail_at=4))
        assert isinstance(err, IOError) and "injected" in str(err)
        return

    def cast_fails(t):
        raise RuntimeError("injected cast failure")

    if where == "prepare":
        monkeypatch.setattr(dev, "to_bf16", cast_fails)
    m, n, k = 40, 24, 20
    ctx = _ctx(tmp_path, c_transfer_dtype="bfloat16")
    try:
        A = bt.mem_array((m, k), np.float32, "R",
                         data=np.ones((m, k), np.float32), ctx=ctx)
        B = bt.mem_array((k, n), np.float32, "R",
                         data=np.ones((k, n), np.float32), ctx=ctx)
        C = bt.FlashArray(_FailingStore(m * n * 4), (m, n), np.float32,
                          "R", ctx=ctx)
        err = _bounded(lambda: bt.gemm(A, B, C, blk=BLK, ctx=ctx))
    finally:
        ctx.destroy()
    assert err is not None and "injected" in str(err)


def test_the_ring_is_made_once_a_context_and_holds_64_mib(tmp_path):
    ctx = _ctx(tmp_path)
    cpu = torch.device("cpu")
    ring = ctx.d2h_ring(cpu)
    assert ctx.d2h_ring(cpu) is ring
    assert sum(s.numel() for s in ring._slots) == 64 << 20
    ctx.destroy()
    assert ctx._d2h_ring is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("rows,cols", [(16, 16), (13, 16), (16, 9), (1, 3),
                                       (0, 16)])
def test_ring_download_hands_over_each_run_in_order(small_slots, dtype,
                                                    rows, cols):
    """`download` hands `consume` the block's first rows x cols in runs
    of whole rows that each fit a slot, in order (bf16 as its bits), drops
    the block, and counts the bytes in d2h.ring_bytes."""
    ring = dev.D2HRing(torch.device("cpu"))
    t = torch.randn(16, 16, dtype=torch.float64).to(dtype)
    fin = dev.Finished(t)
    assert fin.ready is None
    runs = []
    before = METRICS.get("d2h.ring_bytes")
    ring.download(fin, lambda x: x, rows, cols,
                  lambda r, host: runs.append((r, host.copy())), "test")
    assert fin.block is None
    want = (t.view(torch.int16).numpy().view(np.uint16)
            if dtype == torch.bfloat16 else t.numpy())[:rows, :cols]
    got = (np.concatenate([h for _, h in runs]) if runs
           else want[:0])
    assert np.array_equal(got, want) and got.dtype == want.dtype
    assert [r for r, _ in runs] == list(np.cumsum(
        [0] + [len(h) for _, h in runs])[:-1])
    assert all(h.nbytes <= SLOT for _, h in runs)
    assert METRICS.get("d2h.ring_bytes") - before == want.nbytes


def test_ring_refuses_a_row_wider_than_a_slot(small_slots):
    ring = dev.D2HRing(torch.device("cpu"))
    fin = dev.Finished(torch.zeros(2, SLOT))
    with pytest.raises(ValueError, match="does not fit"):
        ring.download(fin, lambda x: x, 2, SLOT, lambda r, h: None, "test")
