"""The port's pipeline plumbing: `core/pipeline.py`'s queue helpers and
`ops/gemm.py:_superblock_pipeline`, the stage engine that the one-card
gemm and `parallel.mesh.gemm_sharded` share.  Host values stand in for
device tiles: the engine only moves and combines what its stages give it.
"""
import gc
import queue
import threading
import weakref

import pytest

from bof_tpu_torch.core.pipeline import join_threads, queue_items
from bof_tpu_torch.ops.gemm import _superblock_pipeline


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
