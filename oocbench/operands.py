"""Operands made from the run's seed, on the device, and their raw files.

Every operand is drawn by one torch.Generator on the run's device, seeded
from (seed, stream) through numpy's SeedSequence, in a few large calls,
so the same seed gives the same bytes and the reference can draw them
again after the window instead of keeping them.  Files are written raw
(dense row-major fp32, or the `.off/.col/.csr` triplet: int64 offsets,
int64 columns, fp32 values) with numpy buffers and `O_DIRECT`, and
synced, so set-up leaves no writes behind for the window's reads to
meet.
"""
from __future__ import annotations

import mmap
import os

import numpy as np
import torch

CHUNK_BYTES = 64 << 20     # one host staging buffer, page-aligned
ALIGN = 4096               # O_DIRECT: buffer, offset and length alignment


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for operand `stream` of run `seed` (any
    non-negative integer; SeedSequence takes seeds wider than 64 bits)."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & ((1 << 63) - 1))
    return gen


def normals(shape, seed: int, stream: int, device) -> torch.Tensor:
    """Standard normals in float32, drawn in one call."""
    return torch.randn(tuple(shape), generator=generator(seed, stream, device),
                       device=device, dtype=torch.float32)


def csr_uniform(m: int, k: int, density: float, seed: int, stream: int,
                device):
    """(ia int64 (m+1,), ja int64 (nnz,), va float32 (nnz,)) of an m x k
    matrix whose nonzeros sit at uniform random columns at `density`
    (Fig. 6's construction): a row's count is Poisson(k * density), capped
    at k, its columns uniform and sorted, its values N(0, 1)."""
    gen = generator(seed, stream, device)
    lam = torch.full((m,), k * density, dtype=torch.float32, device=device)
    counts = torch.poisson(lam, generator=gen).to(torch.int64).clamp_(max=k)
    ia = torch.zeros(m + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=ia[1:])
    nnz = int(ia[-1])
    rows = torch.repeat_interleave(
        torch.arange(m, dtype=torch.int64, device=device), counts)
    cols = torch.randint(0, k, (nnz,), generator=gen, device=device,
                         dtype=torch.int64)
    # row-major order: sort row * k + col; rows are already in order, so
    # the sorted keys keep each row's span and only its columns move
    keys = torch.sort(rows * k + cols).values
    del cols
    ja = keys - rows * k
    del keys, rows
    va = torch.randn(nnz, generator=gen, device=device, dtype=torch.float32)
    return ia, ja, va


def write_csr(prefix: str, ia, ja, va) -> int:
    """The `.off/.col/.csr` triplet at `prefix`; returns the bytes."""
    return (write_raw(prefix + ".off", ia) + write_raw(prefix + ".col", ja)
            + write_raw(prefix + ".csr", va))


def write_raw(path: str, t: torch.Tensor) -> int:
    """Write `t`'s bytes (C order) to a new file at `path` with O_DIRECT,
    through one page-aligned staging buffer; returns the bytes written.
    The last block is padded to the alignment and the file cut back."""
    flat = t.detach().contiguous().view(-1).view(torch.uint8)
    nbytes = flat.numel()
    buf = mmap.mmap(-1, CHUNK_BYTES)
    host = torch.from_numpy(np.frombuffer(buf, np.uint8))
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC | os.O_DIRECT,
                 0o644)
    try:
        for off in range(0, nbytes, CHUNK_BYTES):
            n = min(CHUNK_BYTES, nbytes - off)
            host[:n].copy_(flat[off:off + n])
            padded = -(-n // ALIGN) * ALIGN
            if padded > n:
                host[n:padded].zero_()
            view = memoryview(buf)[:padded]
            done = 0
            while done < padded:
                done += os.write(fd, view[done:])
            view.release()
        os.ftruncate(fd, nbytes)
        # set-up's writes are done before the window reads the file
        os.fsync(fd)
    finally:
        os.close(fd)
        del host
        buf.close()
    return nbytes
