"""Prioritizer — rank ready tasks by bytes-to-prefetch.

Re-design of the reference's Prioritizer (reference: include/scheduler/
prioritizer.h:49-143): among ready tasks, prefer the one whose working set
needs the fewest bytes fetched given the current cache contents — it
becomes computable soonest and maximizes reuse of resident tiles.
`use_prio=False` degrades to FCFS exactly like the reference.
"""
from __future__ import annotations

import collections
from typing import Optional

from .cache import TileCache
from .task import Task, access_key


class Prioritizer:
    def __init__(self, cache: TileCache, use_prio: bool = True):
        self._cache = cache
        self._use_prio = use_prio
        self._deque: collections.deque[Task] = collections.deque()

    def __len__(self):
        return len(self._deque)

    def insert(self, task: Task):
        self._deque.append(task)

    @staticmethod
    def _access_keys(t: Task):
        """Deduped (key, nbytes) pairs of a task, memoized on the task —
        access lists never change after creation, and update() is called
        every scheduler round (profiling showed re-deriving keys per
        round dominated the scheduling cost)."""
        cached = getattr(t, "_prio_keys", None)
        if cached is not None:
            return cached
        pairs = {}
        for store, off, si in t.read_list + t.write_list:
            pairs.setdefault(access_key(store, off, si), si.nbytes)
        t._prio_keys = list(pairs.items())
        return t._prio_keys

    def update(self):
        """Re-rank by bytes not yet resident (reference:
        prioritizer.h:116-139)."""
        if not self._use_prio or len(self._deque) <= 1:
            return
        all_keys = set()
        for t in self._deque:
            for k, _nb in self._access_keys(t):
                all_keys.add(k)
        resident = self._cache.cached_keys(all_keys)

        def mem_reqd(t: Task) -> int:
            return sum(nb for k, nb in self._access_keys(t)
                       if k not in resident)

        self._deque = collections.deque(
            sorted(self._deque, key=mem_reqd))

    def get_prio(self) -> Optional[Task]:
        return self._deque.popleft() if self._deque else None

    def return_prio(self, task: Task):
        self._deque.appendleft(task)
