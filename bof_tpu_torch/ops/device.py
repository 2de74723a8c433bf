"""Device-side steps of the out-of-core kernels, on torch.

The counterpart of `bof_tpu/ops/device.py` (reference: GemmTask::execute,
include/tasks/gemm_task.h:67-93 calls mkl_gemm on cached DRAM blocks):
each superblock accumulate step is one launch of kernel K1
(`matmul_cuda.accum_matmul`) on device-resident tiles, updating the C
accumulator in place — the K chain is ordered by the CUDA stream, as the
reference orders it with parent chains (gemm.cpp:114-126).

Blocks arrive in storage-major layout and K1 absorbs the transposes, so
no host or device transposition happens.  Uploads (`to_device`) are
synchronous with respect to the host buffer they read: the pipeline
unpins a host tile right after `to_device` returns, so a copy still in
flight would read a recycled buffer.  An upload that reads a Program
Cache buffer whole (`is_whole`) finds it page-locked, since the caller
asks the cache to lock it first (`PinRouter.lock`, with the runtime's
functions from `host_lock_fns`): the copy engine then reads it by DMA
instead of the driver staging it through pageable bounce buffers, still
synchronously and on the caller's stream.  Casts, quantized and padded
tiles and ELL bands are fresh arrays and go up pageable.  `to_device`
counts `h2d.bytes` and, for page-locked sources, `h2d.locked_bytes`.
`from_device` is synchronous too.
gemm's finished C blocks go down otherwise: `D2HRing`, a context's two
reused page-locked slots filled on a copy stream of their own, after an
event (`Finished`) that the computing thread recorded behind the block's
last kernel, so the download neither drains nor waits on that thread's
stream.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
import time

import numpy as np
import torch

from ..utils import METRICS
from .matmul_cuda import accum_matmul


def resolve_device(name: str) -> torch.device:
    """The configured device (FlashConfig.device).  A CUDA device on a
    machine without a usable card raises; nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FlashConfig.device={name!r} but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A private device copy of `x` (always a copy, also on the CPU: the
    source may be a pin-cache buffer that is recycled after this call).
    Counts `h2d.bytes`, and `h2d.locked_bytes` where the source is
    page-locked (a Program Cache buffer the caller locked): the copy
    engine then reads it directly instead of the driver staging it."""
    src = torch.from_numpy(np.ascontiguousarray(x))
    METRICS.add("h2d.bytes", src.nbytes)
    if device.type == "cuda" and src.is_pinned():
        METRICS.add("h2d.locked_bytes", src.nbytes)
    return src.to(device, copy=True)


def is_whole(arr: np.ndarray, buf: np.ndarray) -> bool:
    """True iff `arr` is `buf`'s bytes as they stand, all of them and in
    order (a view, not a cast, quantized or padded copy): an upload of
    `arr` then reads a Program Cache buffer whole, and the caller asks
    the cache to page-lock it first."""
    return (arr.flags.c_contiguous and arr.nbytes == buf.nbytes
            and arr.ctypes.data == buf.ctypes.data)


def _cudart():
    """The CUDA runtime library torch has loaded (found among the
    process's mappings), else the one of torch's CUDA major version;
    None where neither loads."""
    torch.cuda.init()
    try:
        with open("/proc/self/maps") as f:
            paths = {line.split()[-1] for line in f
                     if "libcudart.so" in line}
    except OSError:
        paths = set()
    names = sorted(p for p in paths if os.path.basename(p).startswith(
        "libcudart.so"))
    names.append(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def host_lock_fns(device: torch.device):
    """The native pin cache's page-lock hooks for `device`: the addresses
    of `cudaHostRegister`, `cudaHostUnregister` and `cudaGetLastError` (a
    failed registration must not leave the runtime's last error set for
    the thread's next launch check) in torch's CUDA runtime.  None on a
    CPU device, or where the runtime cannot be found: buffers then stay
    pageable."""
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    lib = _cudart()
    if lib is None:
        return None
    return tuple(ctypes.cast(getattr(lib, name), ctypes.c_void_p).value
                 for name in ("cudaHostRegister", "cudaHostUnregister",
                              "cudaGetLastError"))


def to_device_bf16(bits: np.ndarray, device: torch.device) -> torch.Tensor:
    """A private bfloat16 device copy of bf16 values held as their np.uint16
    bits (io/native.py's `cast_bf16`); 2 bytes an element cross the link."""
    bits = np.ascontiguousarray(bits, np.uint16).view(np.int16)
    return to_device(bits, device).view(torch.bfloat16)


def from_device(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t`; a bfloat16 tensor comes back as its np.uint16
    bits (numpy has no bfloat16; io/native.py's `bf16_to_f32` widens
    them)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


class Finished:
    """A finished device block on its way from the thread that computed
    it to the one that downloads it: `block`, a tensor or gemm's
    (K loop's sum, beta * C) pair, and `ready`, an event recorded on the
    computing thread's current stream behind the block's last kernel
    (None on a CPU device).  `D2HRing.download` takes `block` out, so the
    hand-off holds no device memory once the download has begun."""

    __slots__ = ("block", "ready")

    def __init__(self, block):
        self.block = block
        t = block[0] if isinstance(block, tuple) else block
        self.ready = None
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(t.device))


RING_SLOT_BYTES = 32 << 20  # one slot; a finished 8192^2 fp32 block is 8
RING_SLOTS = 2              # the link fills one while the host empties one


class D2HRing:
    """Downloads finished device blocks through RING_SLOTS reused host
    slots of RING_SLOT_BYTES, page-locked on a CUDA device and filled by
    copies on a copy stream of the ring's own, so a download neither
    drains nor queues behind the computing thread's stream and faults in
    no fresh pages (a new pageable 256 MiB array a block went down at
    1.7 GB/s in gemm; PERF.md §6).  On a CPU device the slots are
    ordinary host memory and each copy is done when issued: the same
    schedule, run by the CPU tests.  One ring a context
    (`FlashContext.d2h_ring`); one download at a time."""

    def __init__(self, device: torch.device):
        self.device = device
        cuda = device.type == "cuda"
        self._slot_bytes = RING_SLOT_BYTES
        self._slots = [torch.empty(self._slot_bytes, dtype=torch.uint8,
                                   pin_memory=cuda)
                       for _ in range(RING_SLOTS)]
        self._host = [s.numpy() for s in self._slots]
        self._stream = torch.cuda.Stream(device) if cuda else None
        self._filled = [torch.cuda.Event() if cuda else None
                        for _ in range(RING_SLOTS)]
        # the store ticket that still reads each slot (None: free)
        self._held = [None] * RING_SLOTS
        self._next = 0
        self._lock = threading.Lock()

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _take_slot(self, name: str) -> int:
        s = self._next
        self._next = (s + 1) % RING_SLOTS
        held, self._held[s] = self._held[s], None
        if held is not None:
            with METRICS.span(name + ".d2h_slot_wait"):
                try:
                    held.wait()
                except IOError:
                    pass  # the write's owner waits on it too and raises
        return s

    def download(self, fin: Finished, prepare, rows: int, cols: int,
                 consume, name: str):
        """Bring `prepare(fin.block)[:rows, :cols]` to the host in runs
        of whole rows, each at most a slot, and hand each to
        `consume(first_row, host)` in order: `host` is a (run rows, cols)
        numpy view of a slot (bf16 as its np.uint16 bits), valid until
        `consume` returns, unless it returns a ticket that still reads
        it: the slot is then reused only once that ticket is done.
        `prepare` runs on the copy stream after `fin.ready` (the block
        itself where it needs nothing), so a cast or sum there adds
        nothing to the computing thread's stream.  The block is dropped
        once its last run is queued.  Spans, `name` the entry's: the
        wait for the block's last kernel `<name>.accum_wait`, each run's
        wait for its copy `<name>.d2h` (with its bytes), a wait for a
        slot's store write `<name>.d2h_slot_wait`; the counter
        `d2h.ring_bytes` counts every byte downloaded.  Returns the
        seconds spent in `<name>.d2h`."""
        with self._lock:
            block, fin.block = fin.block, None
            if self._stream is not None:
                self._stream.wait_event(fin.ready)
                for t in (block if isinstance(block, tuple) else (block,)):
                    t.record_stream(self._stream)
            with self._on_stream():
                t = prepare(block)
            del block
            if t.dtype == torch.bfloat16:
                t, np_dtype = t.view(torch.int16), np.dtype(np.uint16)
            else:
                np_dtype = np.dtype(torch.empty(0, dtype=t.dtype)
                                    .numpy().dtype)
            row_bytes = max(cols, 0) * t.element_size()
            if row_bytes > self._slot_bytes:
                raise ValueError(f"a row of {row_bytes} bytes does not fit "
                                 f"a {self._slot_bytes}-byte ring slot")
            step = self._slot_bytes // max(row_bytes, 1)
            runs = ([(r, min(r + step, rows)) for r in range(0, rows, step)]
                    if row_bytes else [])
            queued = collections.deque()

            def issue(k):
                nonlocal t
                r0, r1 = runs[k]
                s = self._take_slot(name)
                nbytes = (r1 - r0) * row_bytes
                view = self._slots[s][:nbytes].view(t.dtype)
                with self._on_stream():
                    view.view(r1 - r0, cols).copy_(t[r0:r1, :cols],
                                                  non_blocking=True)
                    if self._stream is not None:
                        self._filled[s].record(self._stream)
                if k == len(runs) - 1:
                    t = None  # recorded on the copy stream: safe to drop
                queued.append((r0, s, nbytes))

            for k in range(min(RING_SLOTS, len(runs))):
                issue(k)
            with METRICS.span(name + ".accum_wait"):
                if fin.ready is not None:
                    fin.ready.synchronize()
            d2h_s = 0.0
            for k in range(len(runs)):
                r0, s, nbytes = queued.popleft()
                with METRICS.span(name + ".d2h", nbytes) as sp:
                    if self._filled[s] is not None:
                        self._filled[s].synchronize()
                d2h_s += sp.seconds
                METRICS.add("d2h.ring_bytes", nbytes)
                host = self._host[s][:nbytes].view(np_dtype).reshape(
                    nbytes // row_bytes, cols)
                self._held[s] = consume(r0, host)
                if k + RING_SLOTS < len(runs):
                    issue(k + RING_SLOTS)
            return d2h_s


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    """Device-side cast for c_transfer_dtype='bfloat16' (bof_tpu's
    `to_bf16`): a finished C block rounds once (to nearest even) on the
    device, so half the bytes cross the link."""
    return t.to(torch.bfloat16)


def dtype_native_on_device(dt) -> bool:
    """True iff the port's device kernels compute in `dt` exactly.  The
    sparse kernels (K2, the SpMV) are fp32, so 64-bit values take the
    exact scipy host path instead of narrowing — as bof_tpu does on a TPU
    and on a CPU without x64 (an fp64 K2 is ROADMAP work)."""
    return np.dtype(dt).itemsize < 8


_link_gbps: dict = {}


def link_gbps_estimate(device: torch.device) -> float:
    """One-shot measured host->device rate (GB/s) for `device`, cached per
    device for the process: one 8 MiB incompressible upload, synchronized.
    Drives the sparse compute-placement heuristic ('auto').  A CPU device
    has no link to cross: infinite."""
    if device.type == "cpu":
        return float("inf")
    key = str(device)
    if key not in _link_gbps:
        x = np.random.default_rng(99).integers(0, 256, 8 << 20,
                                               dtype=np.uint8)
        sync(to_device(x[:1 << 16], device))  # warm the path
        t0 = time.perf_counter()
        sync(to_device(x, device))
        _link_gbps[key] = x.nbytes / max(time.perf_counter() - t0,
                                         1e-9) / 1e9
    return _link_gbps[key]


def sync(t: torch.Tensor) -> None:
    """Block until the work queued before this call on `t`'s device (on
    the calling thread's current stream) has finished."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def zeros_block(shape, device: torch.device,
                dtype=np.float32) -> torch.Tensor:
    """A fresh C accumulator (beta == 0), in C's numpy `dtype`."""
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    return torch.zeros(shape, dtype=tdt, device=device)


def scale_init(c: torch.Tensor, beta: float) -> torch.Tensor:
    """C-block initialization for beta != 0 (reference reads C and lets MKL
    apply beta, gemm_task.h:49-54; we scale once before the K loop), in
    place."""
    return c.mul_(beta)


def accum_step(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               alpha: float, *, a_km: bool, b_nk: bool, c_nm: bool,
               prec: str = "highest") -> torch.Tensor:
    """c += alpha * op(A) op(B), all in storage-major layout, in place.

    a: (bm,bk) if not a_km else (bk,bm)
    b: (bk,bn) if not b_nk else (bn,bk)
    c: (bm,bn) if not c_nm else (bn,bm)

    `prec` takes bof_tpu's values, each at least as precise as the TPU's
    tier: 'highest' and 'high' run K1 as 3xTF32, 'default' as one TF32
    pass (`matmul_cuda.K1_PASSES`); an unknown value raises ValueError.
    bf16 tiles (transfer_dtype='bfloat16') run K1's 'bf16' variant at every
    `prec`, with the fp32 accumulator bof_tpu keeps for them; float64
    tiles run K1's 'f64' variant (DMMA) at every `prec`."""
    return accum_matmul(c, a, b, alpha, a_km=a_km, b_nk=b_nk, c_nm=c_nm,
                        prec=prec)


def accum_step_q(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 scale: float, *, a_km: bool, b_nk: bool,
                 c_nm: bool) -> torch.Tensor:
    """The quantized step of transfer_dtype='int8' (bof_tpu's
    `accum_step_q`): a and b are int8 tiles (per-tile max-abs
    quantizations), their product is summed exactly in int32 and
    c += scale * f32(sum) with scale = alpha * s_a * s_b, in place: K1's
    's8' variant.  Input rounding is the only error."""
    return accum_matmul(c, a, b, scale, a_km=a_km, b_nk=b_nk, c_nm=c_nm)
