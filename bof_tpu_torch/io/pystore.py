"""Pure-Python file store: portable fallback I/O engine.

Plays the role of the reference's FlashFileHandle+IoExecutor pair
(reference: src/file_handles/flash_file_handle.cpp, src/scheduler/
io_executor.cpp) when the native engine is unavailable: a pool of I/O
threads services strided reads/writes with `os.pread/os.pwrite`, one
sub-op per stride run (reference issues one iocb per stride,
flash_file_handle.cpp:429-506), large runs split at `max_chunk_bytes`
(reference MAX_CHUNK_SIZE=32MiB, flash_file_handle.cpp:25).

Threads block in the kernel with the GIL released, so reads across threads
genuinely overlap; on NVMe this saturates the device without kernel AIO.
The native engine (native.py) adds O_DIRECT + linux AIO.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np

from ..utils import LOG
from .store import BaseStore, Ticket, _check_access
from .stride import StrideInfo


class _Op:
    __slots__ = ("fd", "file_off", "buf", "is_write", "state")

    def __init__(self, fd, file_off, buf, is_write, state):
        self.fd, self.file_off, self.buf = fd, file_off, buf
        self.is_write, self.state = is_write, state


class _TicketState:
    __slots__ = ("remaining", "ticket", "lock")

    def __init__(self, n_ops: int, ticket: Ticket):
        self.remaining = n_ops
        self.ticket = ticket
        self.lock = threading.Lock()

    def op_done(self, error: Optional[str]):
        with self.lock:
            self.remaining -= 1
            if error and not self.ticket._error:
                self.ticket._error = error
            last = self.remaining == 0
        if last:
            self.ticket._complete(self.ticket._error)


class PyIoPool:
    """Shared I/O thread pool (IoExecutor analog)."""

    def __init__(self, n_threads: int = 8):
        self._q: queue.Queue = queue.Queue()
        self._threads = []
        self._shutdown = False
        for i in range(n_threads):
            t = threading.Thread(target=self._worker, name=f"bof-io-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def submit(self, op: _Op):
        self._q.put(op)

    def _worker(self):
        while True:
            op = self._q.get()
            if op is None:
                return
            err = None
            try:
                if op.is_write:
                    mv = memoryview(op.buf)
                    off = op.file_off
                    while len(mv):
                        n = os.pwrite(op.fd, mv, off)
                        mv = mv[n:]
                        off += n
                else:
                    view = op.buf
                    off = op.file_off
                    pos = 0
                    while pos < len(view):
                        chunk = os.pread(op.fd, len(view) - pos, off + pos)
                        if not chunk:
                            # read past EOF: zero-fill like the native
                            # engine (full_pread) — sparse/short files are
                            # part of the store contract
                            view[pos:] = 0
                            break
                        view[pos:pos + len(chunk)] = np.frombuffer(
                            chunk, dtype=np.uint8)
                        pos += len(chunk)
            except Exception as e:  # pragma: no cover - error path
                # broader than OSError: ANY worker exception must complete
                # the ticket (e.g. TypeError from a closed store's fd=None)
                # or the waiter hangs forever AND the pool thread dies
                err = f"{type(e).__name__}: {e}"
            op.state.op_done(err)

    def close(self):
        if self._shutdown:
            return
        self._shutdown = True
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=5)


class PyFileStore(BaseStore):
    """File-backed store serviced by a shared PyIoPool."""

    def __init__(self, path: str, pool: PyIoPool, create: bool = False,
                 truncate_to: int = 0, max_chunk_bytes: int = 32 << 20):
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags, 0o644)
        self.path = path
        self._pool = pool
        self._max_chunk = max_chunk_bytes
        # serializes close() against flush/size: a check-then-act on the
        # raw fd could fsync an OS-recycled fd (CLAUDE.md: fds recycle)
        self._fd_lock = threading.Lock()
        if truncate_to:
            os.ftruncate(self._fd, truncate_to)

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def file_identity(self):
        with self._fd_lock:
            if self._fd is None:
                return None
            st = os.fstat(self._fd)
            return (st.st_dev, st.st_ino)

    def truncate(self, nbytes: int):
        os.ftruncate(self._fd, nbytes)

    def _submit(self, offset: int, sinfo: StrideInfo, buf: np.ndarray,
                is_write: bool) -> Ticket:
        _check_access(sinfo, buf)
        # Split into per-run ops; split runs bigger than max_chunk.
        ops = []
        for i in range(sinfo.n_strides):
            fo = offset + i * sinfo.stride
            bo = i * sinfo.len_per_stride
            ln = sinfo.len_per_stride
            while ln > 0:
                c = min(ln, self._max_chunk)
                ops.append((fo, bo, c))
                fo, bo, ln = fo + c, bo + c, ln - c
        if not ops:  # zero-byte access: nothing will ever call op_done
            return Ticket.completed()
        ticket = Ticket(buf)
        state = _TicketState(len(ops), ticket)
        for fo, bo, c in ops:
            self._pool.submit(_Op(self._fd, fo, buf[bo:bo + c], is_write, state))
        return ticket

    def read(self, offset: int, sinfo: StrideInfo, out: np.ndarray) -> Ticket:
        return self._submit(offset, sinfo, out, is_write=False)

    def write(self, offset: int, sinfo: StrideInfo, src: np.ndarray) -> Ticket:
        return self._submit(offset, sinfo, src, is_write=True)

    def flush(self):
        with self._fd_lock:
            if self._fd is None:
                return  # closed concurrently (freed scratch)
            os.fsync(self._fd)

    def close(self):
        with self._fd_lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:  # pragma: no cover
                    LOG.warning("close failed for %s", self.path)
                self._fd = None
