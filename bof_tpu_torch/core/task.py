"""Task model (reference: include/tasks/task.h).

A Task is the unit of schedulable work: it declares its disk reads/writes as
(store, offset, StrideInfo) accesses (reference: add_read/add_write,
task.h:57-67), depends on parent task ids (task.h:71-76), may chain a
continuation (`next`, task.h:79-84), and carries a status machine
Wait→AllocReady→Alloc→ComputeReady→Compute→Complete (task.h:15-22).  The
cache fills `task.buffers` with host views of every declared access before
`execute()` runs (reference: in_mem_ptrs, task.h:33-34).
"""
from __future__ import annotations

import enum
import itertools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.store import BaseStore, store_uid
from ..io.stride import StrideInfo

# Unique task ids (reference: global_task_counter, lib_funcs.cpp:16).
_task_counter = itertools.count()
_MAX_ACCESS_BYTES = 1 << 35  # reference asserts each access < 2^35 B (task.h:59)


class TaskStatus(enum.IntEnum):
    WAIT = 0
    ALLOC_READY = 1
    ALLOC = 2
    COMPUTE_READY = 3
    COMPUTE = 4
    COMPLETE = 5


def access_key(store: BaseStore, offset: int, sinfo: StrideInfo):
    """Cache key for one access (reference hashes Key{fptr,sinfo} with
    fnv64a, cache.h:11-42; Python tuples hash natively).  Keyed on a
    process-unique store uid — id(store) addresses are recycled by GC.
    Hot: called per access per prioritizer round — no per-call imports."""
    return (store_uid(store), offset, sinfo)


class Task:
    def __init__(self):
        self.id: int = next(_task_counter)
        self.read_list: List[Tuple[BaseStore, int, StrideInfo]] = []
        self.write_list: List[Tuple[BaseStore, int, StrideInfo]] = []
        self.parents: List[int] = []
        self.next: Optional["Task"] = None
        self._status = TaskStatus.WAIT
        self._status_lock = threading.Lock()
        self.error: Optional[BaseException] = None
        # key -> uint8 host buffer, filled by the cache before execute()
        self.buffers: Dict[tuple, np.ndarray] = {}

    # ------------------------------------------------------- declarations
    def add_read(self, store: BaseStore, offset: int, sinfo: StrideInfo):
        assert sinfo.nbytes < _MAX_ACCESS_BYTES
        self.read_list.append((store, offset, sinfo))

    def add_write(self, store: BaseStore, offset: int, sinfo: StrideInfo):
        assert sinfo.nbytes < _MAX_ACCESS_BYTES
        self.write_list.append((store, offset, sinfo))

    def add_parent(self, task_id: int):
        self.parents.append(task_id)

    def add_next(self, task: "Task"):
        self.next = task

    # ------------------------------------------------------------ status
    def get_status(self) -> TaskStatus:
        with self._status_lock:
            return self._status

    def set_status(self, s: TaskStatus):
        with self._status_lock:
            self._status = s

    # ----------------------------------------------------------- helpers
    def buf(self, store: BaseStore, offset: int, sinfo: StrideInfo,
            dtype=np.float32) -> np.ndarray:
        """Typed view of a cached access buffer inside execute()."""
        return self.buffers[access_key(store, offset, sinfo)].view(dtype)

    @property
    def size(self) -> int:
        """Total bytes this task touches (reference: BaseTask::size)."""
        seen = {}
        for store, off, si in self.read_list + self.write_list:
            seen[access_key(store, off, si)] = si.nbytes
        return sum(seen.values())

    def execute(self):  # pragma: no cover - abstract
        raise NotImplementedError


class FnTask(Task):
    """Task whose execute() is a closure over its cached buffers."""

    def __init__(self, fn=None):
        super().__init__()
        self._fn = fn

    def execute(self):
        if self._fn is not None:
            self._fn(self)
