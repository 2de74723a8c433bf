"""B10, the stable block sort of the out-of-core sample sort, on torch.

bof_tpu's device block sorter (`bof_tpu/ops/sort.py:135` `sort_block`,
branch :138-149) is `jnp.sort` of the block.  Here it is the hand-written
CUDA kernel `bof_sort_block` (`csrc/sort.cu`), which `sort_block`
launches on a CUDA tensor; a CPU tensor takes the plain version
`sort_block_ref`.  `sort_block.launches` counts the kernel's launches
(one a block sort, whatever its passes).

The order is jnp.sort's: stable, ascending by a canonical key of each
element's bits (`canonical_keys`: for floats -0.0 equals +0.0 and every
NaN equals every other and sorts last; signed integers by value; unsigned
integers and bool by their bits).  Every element comes back with its own
bits, so a -NaN stays -NaN (np.sort, the host sorter, makes it +NaN) and
-0.0 and +0.0 keep their input order (torch.sort on a CUDA float tensor
puts -0.0 first).

A block travels as a tensor of its elements' bits: any dtype of the
element's width (`bits_of` makes one from a numpy block, without a copy),
with the numpy dtype the bits hold given beside it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sparse.spmm_cuda import _launch
from .cuda_lib import build

# the element types B10 sorts, by csrc/sort.cu's kind numbers (bool sorts
# as uint8); 64-bit elements take the host sort (ops/sort.py)
SORT_KINDS = {
    np.dtype(np.float32): 0, np.dtype(np.float16): 1,
    np.dtype(np.int32): 2, np.dtype(np.uint32): 3,
    np.dtype(np.int16): 4, np.dtype(np.uint16): 5,
    np.dtype(np.int8): 6, np.dtype(np.uint8): 7, np.dtype(np.bool_): 7,
}
SORT_TILE = 7680  # csrc/sort.cu: SORT_THREADS * SORT_ITEMS, a block's tile
SORT_MAX_ELEMS = 2 ** 31 - SORT_TILE  # int positions over whole tiles
_NP_BITS = {4: np.int32, 2: np.int16, 1: np.uint8}
_TORCH_BITS = {4: torch.int32, 2: torch.int16, 1: torch.uint8}


def device_sortable(dt) -> bool:
    """True iff B10 has a key for elements of numpy dtype `dt`."""
    return np.dtype(dt) in SORT_KINDS


def bits_of(x: np.ndarray) -> torch.Tensor:
    """A CPU tensor over the bits of the 1-D numpy block x (no copy)."""
    return torch.from_numpy(x.view(_NP_BITS[x.itemsize]))


def _check(bits: torch.Tensor, dtype) -> int:
    dt = np.dtype(dtype)
    if dt not in SORT_KINDS:
        raise ValueError(f"sort_block: no device key for {dt} (it takes "
                         f"{sorted({d.name for d in SORT_KINDS})})")
    if (bits.dim() != 1 or not bits.is_contiguous()
            or bits.element_size() != dt.itemsize):
        raise ValueError(f"sort_block takes a contiguous 1-D tensor of "
                         f"{dt.itemsize}-byte elements, got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sort_block: unsupported device {bits.device}")
    return SORT_KINDS[dt]


def canonical_keys(bits: torch.Tensor, dtype) -> torch.Tensor:
    """int64 keys of the elements whose bits `bits` holds (numpy dtype
    `dtype`), in B10's order: for floats -0 maps to +0 and any NaN above
    +inf's key, then the sign bit of a positive value flips and every bit
    of a negative one; a signed integer's sign bit flips; unsigned integers
    and bool are their bits."""
    dt = np.dtype(dtype)
    width = 8 * dt.itemsize
    ones = (1 << width) - 1
    sign = 1 << (width - 1)
    b = bits.view(_TORCH_BITS[dt.itemsize]).to(torch.int64) & ones
    if dt.kind == "f":
        inf = {32: 0x7F800000, 16: 0x7C00}[width]
        nan = (b & (sign - 1)) > inf
        b = torch.where(b == sign, 0, b)
        b = torch.where((b & sign) != 0, b ^ ones, b | sign)
        return torch.where(nan, ones, b)
    if dt.kind == "i":
        return b ^ sign
    return b


def sort_block_ref(bits: torch.Tensor, dtype) -> torch.Tensor:
    """Plain version of `sort_block`: a stable torch.sort of the canonical
    keys, and the bits gathered in that order."""
    _check(bits, dtype)
    order = torch.sort(canonical_keys(bits, dtype), stable=True).indices
    return bits[order]


def sort_block(bits: torch.Tensor, dtype) -> torch.Tensor:
    """The block sorted ascending, stably, by `canonical_keys`; each
    element keeps its bits.  `bits` is a contiguous 1-D tensor of the
    elements' width holding elements of numpy dtype `dtype` (float32,
    float16, int32, uint32, int16, uint16, int8, uint8 or bool), at most
    SORT_MAX_ELEMS of them.  Returns a new tensor of bits's dtype; a CUDA
    tensor launches B10 on the current stream, a CPU tensor takes
    `sort_block_ref`."""
    kind = _check(bits, dtype)
    n = bits.numel()
    if n > SORT_MAX_ELEMS:
        raise ValueError(f"sort_block: {n} elements exceed {SORT_MAX_ELEMS}")
    if bits.device.type == "cpu":
        return sort_block_ref(bits, dtype)
    out = torch.empty_like(bits)
    if n == 0:
        return out
    lib = build()
    scratch = torch.empty_like(bits) if bits.element_size() > 1 else out
    # the status words, digit counts and starts, tile counters (zeroed on
    # the stream by the kernel's own memset)
    work = torch.empty(lib.bof_sort_block_scratch_ints(n), dtype=torch.int32,
                       device=bits.device)
    _launch(lib.bof_sort_block, bits.device, out.data_ptr(), bits.data_ptr(),
            scratch.data_ptr(), work.data_ptr(), n, kind)
    sort_block.launches += 1
    return out


def reset_launch_counts() -> None:
    """Set B10's launch count to 0."""
    sort_block.launches = 0


reset_launch_counts()
