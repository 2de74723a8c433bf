"""Pipeline helpers shared by the kernel planners.

`PrefetchSeq`: given an ordered list of accesses, keeps `depth` of them
pinned ahead in the tile cache so disk I/O overlaps with device compute —
the planner-side expression of the reference's prefetch pipeline (the
Prioritizer+backlog machinery services the pins).  `TicketWindow` bounds
the async writes in flight.  `queue_put`, `queue_put_sentinel`,
`queue_items`, `run_stage` and `join_threads` are the stage threads' one
shutdown protocol: bounded, timed queues and a shared error list.  A get
or put on a pipeline queue runs inside the span its caller names
(METRICS.span, `<entry>.queue_wait`): one stage waiting on another.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils import METRICS
from .cache import TileCache


def _hand_off(span: Optional[str]):
    return METRICS.span(span) if span else contextlib.nullcontext()


class PrefetchSeq:
    """Sequential prefetcher: access i is pinned `depth` steps early;
    call get(i) in order, then done(i)."""

    def __init__(self, cache: TileCache,
                 accesses: Sequence[Tuple[object, int, object]],
                 depth: int = 4):
        self._cache = cache
        self._accesses = list(accesses)
        self._depth = max(1, depth)
        self._keys: dict[int, tuple] = {}
        self._next_pin = 0
        self._pump(0)

    def _pump(self, upto: int):
        while (self._next_pin < len(self._accesses)
               and self._next_pin <= upto + self._depth - 1):
            st, off, si = self._accesses[self._next_pin]
            self._keys[self._next_pin] = self._cache.pin_read(st, off, si)
            self._next_pin += 1

    def get(self, idx: int) -> np.ndarray:
        self._pump(idx)
        key = self._keys[idx]
        self._cache.wait_ready(key)
        return self._cache.buf(key)

    def lock(self, idx: int) -> bool:
        """Page-lock access idx's pinned buffer, which the caller is about
        to upload whole (`PinRouter.lock`); True if it is page-locked."""
        return self._cache.lock(self._keys[idx])

    def done(self, idx: int):
        key = self._keys.pop(idx, None)
        if key is not None:
            self._cache.unpin(key)

    def close(self):
        for key in self._keys.values():
            self._cache.unpin(key)
        self._keys.clear()


class TicketWindow:
    """Bounded in-flight write-ticket window.  Every store write Ticket
    holds its source buffer alive until wait(), so accumulating all of a
    kernel's write-backs to the end grows host RAM to the full padded
    output size — the exact out-of-core regime these kernels exist for.
    `depth` tickets in flight keeps the disk writer busy while bounding
    the buffers (one shared helper instead of per-kernel copies).  Each
    wait, at a full window or at the end, runs inside the span `span`
    (e.g. "gemm.write_wait"), where one is named."""

    __slots__ = ("_dq", "_depth", "_span")

    def __init__(self, depth: int = 8, span: Optional[str] = None):
        import collections
        self._dq = collections.deque()
        self._depth = max(1, depth)
        self._span = span

    def _wait_one(self) -> None:
        with _hand_off(self._span):
            self._dq.popleft().wait()

    def push(self, t) -> None:
        self._dq.append(t)
        while len(self._dq) > self._depth:
            self._wait_one()

    def extend(self, ts) -> None:
        for t in ts:
            self.push(t)

    def wait_all(self) -> None:
        while self._dq:
            self._wait_one()

    def __len__(self) -> int:
        return len(self._dq)


def queue_put(q, item, errors, span: Optional[str] = None,
              timeout: float = 1.0) -> bool:
    """Timeout-put guarded by a shared error list: a dead consumer can
    never block a producer forever (the producer may be holding pinned
    tiles).  Returns False once an error is recorded.  Shared by the
    gemm/csrmm/sharded pipeline stages — one shutdown protocol, not four
    hand-rolled copies.  The put runs inside the span `span`."""
    import queue as _queue
    with _hand_off(span):
        while not errors:
            try:
                q.put(item, timeout=timeout)
                return True
            except _queue.Full:
                continue
    return False


def queue_put_sentinel(q, errors):
    """Deliver the end-of-stream None even against a full queue; once an
    error is recorded, make one non-blocking attempt (to unblock a live
    consumer mid-get) and give up — consumers key their shutdown off the
    shared error list."""
    import queue as _queue
    while not errors:
        try:
            q.put(None, timeout=1.0)
            return
        except _queue.Full:
            continue
    try:
        q.put_nowait(None)
    except _queue.Full:
        pass


def queue_items(q, errors, span: Optional[str] = None):
    """The items of a pipeline queue up to its None: timeout-gets, so a
    consumer whose producer died (the error-path None can be dropped on a
    full queue) ends once an error is recorded and the queue is empty.
    Each get runs inside the span `span`."""
    import queue as _queue
    while True:
        with _hand_off(span):
            box = None
            while box is None:
                try:
                    box = [q.get(timeout=1.0)]
                except _queue.Empty:
                    if errors:
                        return
        if box[0] is None:
            return
        # popped, not bound: the consumer alone holds the item (and may
        # drop a device buffer in it before the next get)
        yield box.pop()


def run_stage(stage, errors, out_q=None) -> None:
    """A stage thread's body: `stage()`, its exception recorded in
    `errors`, then its out-queue (if any) ended, whatever happened."""
    try:
        stage()
    except BaseException as e:
        errors.append(e)
    if out_q is not None:
        queue_put_sentinel(out_q, errors)


def join_threads(threads, errors) -> None:
    """Join a pipeline's stage threads: unbounded while healthy (a writer
    on a slow disk can outlast any fixed timeout, and returning early
    would report success with writes in flight), 30 s each once an error
    is recorded."""
    for t in threads:
        while t.is_alive():
            t.join(timeout=1.0)
            if errors:
                t.join(timeout=30)
                break
