"""Strided access specifiers.

The reference declares every disk access as a `StrideInfo{stride, n_strides,
len_per_stride}` (reference: include/file_handles/file_handle.h:19-34) — a
fixed-stride gather/scatter pattern covering matrix sub-blocks.  We keep the
same abstraction: a strided READ gathers `n_strides` runs of
`len_per_stride` bytes, spaced `stride` bytes apart in the file, into one
contiguous host buffer; a strided WRITE scatters a contiguous buffer back.
"""
from __future__ import annotations

from typing import NamedTuple


class StrideInfo(NamedTuple):
    stride: int          # bytes between consecutive run starts in the file
    n_strides: int       # number of runs
    len_per_stride: int  # bytes per run

    @property
    def nbytes(self) -> int:
        """Bytes transferred (contiguous side)."""
        return self.n_strides * self.len_per_stride

    @property
    def file_extent(self) -> int:
        """Bytes spanned in the file from the access's base offset."""
        if self.n_strides == 0:
            return 0
        return (self.n_strides - 1) * self.stride + self.len_per_stride

    @staticmethod
    def contiguous(nbytes: int) -> "StrideInfo":
        return StrideInfo(stride=nbytes, n_strides=1, len_per_stride=nbytes)

    def is_contiguous(self) -> bool:
        return self.n_strides == 1 or self.stride == self.len_per_stride


def buf_size(sinfo: StrideInfo) -> int:
    """Host buffer size for an access (reference: src/utils.cpp:48-53
    overprovisions single-stride buffers by a sector for alignment slop; we
    allocate exactly — alignment is handled inside the native engine)."""
    return sinfo.nbytes
