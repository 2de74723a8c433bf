"""The port's pipeline plumbing: `core/pipeline.py`'s queue helpers and
stage wrapper, `ops/gemm.py:_superblock_pipeline`, the stage engine that
the one-card gemm and `parallel.mesh.gemm_sharded` share, and their one
accumulator (`BlockAccumulator`).  Host values stand in for device tiles:
the engine only moves and combines what its stages give it.
"""
import gc
import queue
import threading
import weakref

import numpy as np
import pytest
import torch

from bof_tpu_torch.core.pipeline import join_threads, queue_items, run_stage
from bof_tpu_torch.ops.gemm import BlockAccumulator, _superblock_pipeline


class _Tile:
    pass


def test_queue_items_yields_until_the_sentinel():
    q = queue.Queue()
    for x in (1, 2, 3, None, 4):
        q.put(x)
    assert list(queue_items(q, [])) == [1, 2, 3]


def test_queue_items_ends_on_an_error_once_the_queue_is_empty():
    q = queue.Queue()
    q.put(7)
    assert list(queue_items(q, [RuntimeError("a stage failed")])) == [7]


def test_queue_items_keeps_no_reference_to_the_item_it_yielded():
    """A consumer that drops an item (a device buffer) before its next get
    frees it: the generator holds none."""
    q = queue.Queue()
    q.put(_Tile())
    q.put(None)
    items = queue_items(q, [])
    ref = weakref.ref(next(items))
    gc.collect()
    assert ref() is None
    assert list(items) == []


def test_join_threads_returns_once_the_threads_end():
    done = []
    threads = [threading.Thread(target=done.append, args=(i,))
               for i in range(3)]
    for t in threads:
        t.start()
    join_threads(threads, [])
    assert sorted(done) == [0, 1, 2]


@pytest.mark.parametrize("outcome", ["returns", "raises", "raises_full"])
def test_run_stage_records_the_error_and_ends_the_queue(outcome):
    """A stage that returns ends its out-queue with None; one that raises
    has its error recorded and still ends the queue, without blocking on
    a full one."""
    q = queue.Queue(maxsize=1)
    if outcome == "raises_full":
        q.put("item")
    errors = []

    def stage():
        if outcome != "returns":
            raise RuntimeError("stage failed")

    t = threading.Thread(target=run_stage, args=(stage, errors, q))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert [str(e) for e in errors] == ([] if outcome == "returns"
                                        else ["stage failed"])
    assert q.get_nowait() == ("item" if outcome == "raises_full" else None)


def test_run_stage_without_a_queue_only_records():
    errors = []
    run_stage(lambda: 1 / 0, errors)
    assert isinstance(errors[0], ZeroDivisionError)


@pytest.mark.parametrize("mode", ["float32", "float64", "int8",
                                  "float32_beta0"])
def test_block_accumulator_is_alpha_sum_plus_beta_c(mode):
    """start / accum / finish give alpha * sum of the steps + beta * C:
    float32 from beta * C, float64 with beta * C added in finish (the
    accumulator a pair until then), int8 with one scale a step computed
    in float32 from alpha and the tiles' scales."""
    dtype = np.float64 if mode == "float64" else np.float32
    alpha, beta = 1.5, (0.0 if mode == "float32_beta0" else 0.25)
    tdt = torch.float64 if mode == "float64" else torch.float32
    c = torch.full((2, 3), 4.0, dtype=tdt)
    calls = []

    def step(c_dev, a, b, alpha_s):
        calls.append(alpha_s)
        return c_dev.add_(alpha_s * a * b)

    def step_q(c_dev, a_q, b_q, scale):
        calls.append(scale)
        return c_dev.add_(scale * a_q * b_q)

    acc = BlockAccumulator((2, 3), torch.device("cpu"), dtype, alpha, beta,
                           step, step_q if mode == "int8" else None)
    cur = acc.start(None if beta == 0.0 else c.clone())
    assert isinstance(cur, tuple) == (mode == "float64")
    tiles = [(2.0, 3.0), (1.0, 5.0)]
    for a, b in tiles:
        if mode == "int8":
            cur = acc.accum(cur, (a, np.float32(0.5)), (b, np.float32(0.1)))
        else:
            cur = acc.accum(cur, a, b)
    got = acc.finish(cur)
    if mode == "int8":
        scale = float(np.float32(alpha * np.float32(0.5) * np.float32(0.1)))
        assert calls == [scale, scale]
        want = beta * 4.0 + scale * sum(a * b for a, b in tiles)
    else:
        assert calls == [alpha, alpha]
        want = beta * 4.0 + alpha * sum(a * b for a, b in tiles)
    assert got.dtype == tdt
    torch.testing.assert_close(got, torch.full((2, 3), want, dtype=tdt))


def _steps(mB, nB, kB):
    return [(i, j, l) for j in range(nB) for i in range(mB)
            for l in range(kB)]


@pytest.mark.parametrize("grouped", [False, True])
def test_superblock_pipeline_accumulates_each_block_over_k(grouped):
    """Every (i, j) block starts from its c_init and takes its kB
    accumulations in order, also when several j are live at once (the
    one-card gemm's grouped schedule)."""
    mB, nB, kB = 2, 3, 4
    steps = (_steps(mB, nB, kB) if not grouped else
             [(i, j, l) for i in range(mB) for l in range(kB)
              for j in range(nB)])
    written = {}

    def produce(put):
        for (i, j, l) in steps:
            c_init = f"C{i}{j}" if l == 0 else None
            if not put((l, (i, j), c_init)):
                return

    def accum(c, a, b):
        return c + [(a, b)]

    def write_all(blocks):
        for i, j, fin in blocks:  # fin: a device.Finished
            written[(i, j)] = fin.block

    _superblock_pipeline(steps, kB, 2, produce, lambda c_init: [c_init],
                         accum, write_all, "gemm")
    assert written == {(i, j): [f"C{i}{j}"] + [(l, (i, j))
                                               for l in range(kB)]
                       for i in range(mB) for j in range(nB)}


@pytest.mark.parametrize("stage", ["produce", "accum", "write"])
def test_superblock_pipeline_raises_a_stage_failure_without_hanging(stage):
    steps = _steps(2, 2, 3)

    def produce(put):
        for n, _ in enumerate(steps):
            if stage == "produce" and n == 4:
                raise RuntimeError("produce failed")
            if not put((1, None, None)):
                return

    def accum(c, a, b):
        if stage == "accum":
            raise RuntimeError("accum failed")
        return c + a

    def write_all(blocks):
        for _ in blocks:
            if stage == "write":
                raise RuntimeError("write failed")

    with pytest.raises(RuntimeError, match=f"{stage} failed"):
        _superblock_pipeline(steps, 3, 1, produce, lambda c: 0, accum,
                             write_all, "gemm")
