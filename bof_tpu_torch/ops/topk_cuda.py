"""B8, the masked row top-k of the fused XML ranking step, on torch.

bof_tpu's fused step (`bof_tpu/apps/xml_rank.py:48` `_topk_step`) adds a
label mask (0 on real labels, -inf on the padded tail) to the ELL block
product and takes `jax.lax.top_k` of each row.  Here the product is kernel
K2 (`sparse/spmm_cuda.py`) and the top-k is the hand-written CUDA kernel
`bof_row_topk` (`csrc/topk.cu`), which `row_topk` launches on a CUDA tensor;
a CPU tensor takes the plain version `row_topk_ref`.  `row_topk.launches`
counts the kernel's launches, and `.variant_launches` them by the body
that ran (`topk_variant`: 'reg', a warp a row with the keys in registers,
up to `TOPK_REG_COLS` columns; 'smem', a block a row with the keys in
shared memory, up to `TOPK_SMEM_COLS`; 'l2' beyond).

The order is lax.top_k's on the CPU: XLA's total order of floats (+NaN
above +inf, -NaN below -inf, +0 above -0), the lower column first among
equal values; the values returned are the masked scores' own bits.  On
the card the mask's add returns the canonical +NaN for a -NaN score, so
there it ranks first (a deliberate difference, ROADMAP C).
"""
from __future__ import annotations

import torch

from ..sparse.spmm_cuda import _launch
from .cuda_lib import build

TOPK_REG_COLS = 1024   # csrc/topk.cu's TOPK_REG_COLS
TOPK_SMEM_COLS = 4096  # csrc/topk.cu's TOPK_SMEM_COLS
TOPK_VARIANTS = ("reg", "smem", "l2")


def topk_variant(cols: int) -> str:
    """The body csrc/topk.cu runs for rows of `cols` columns."""
    if cols <= TOPK_REG_COLS:
        return "reg"
    return "smem" if cols <= TOPK_SMEM_COLS else "l2"


def _check(s, mask, k):
    if s.dim() != 2 or s.dtype != torch.float32 or not s.is_contiguous():
        raise ValueError("row_topk takes a contiguous fp32 (rows, cols) "
                         f"tensor, got {s.dtype} {tuple(s.shape)}")
    rows, cols = s.shape
    if rows > 2 ** 31 - 1:
        raise ValueError(f"row_topk: {rows} rows exceed one grid")
    if not 1 <= k <= cols:
        raise ValueError(f"row_topk: k={k} out of range [1, {cols}]")
    if mask is not None and (mask.dtype != torch.float32
                             or tuple(mask.shape) != (cols,)
                             or mask.device != s.device
                             or not mask.is_contiguous()):
        raise ValueError(f"row_topk: mask must be contiguous fp32 ({cols},) "
                         f"on {s.device}")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_topk: unsupported device {s.device}")


def row_topk_ref(s: torch.Tensor, mask, k: int):
    """Plain version of `row_topk`: a stable descending sort of the masked
    rows' int32 keys in XLA's total order of floats (the bits b for
    b >= 0, b ^ 0x7FFFFFFF for b < 0), cut to k.  Returns (values fp32
    (rows, k), columns int32 (rows, k))."""
    x = s if mask is None else s + mask[None, :]
    bits = x.view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    _, order = torch.sort(keys, dim=1, descending=True, stable=True)
    cols = order[:, :k]
    return torch.gather(x, 1, cols), cols.to(torch.int32)


def row_topk(s: torch.Tensor, mask, k: int):
    """The k largest entries of each row of s + mask[None, :] and their
    columns, value descending, the lower column first on equal values
    (lax.top_k's order).  s (rows, cols) fp32 contiguous, mask (cols,) fp32
    or None, 1 <= k <= cols.  Returns (values fp32 (rows, k), columns int32
    (rows, k)); a CUDA tensor launches B8 on the current stream, a CPU
    tensor takes `row_topk_ref`."""
    _check(s, mask, k)
    if s.device.type == "cpu":
        return row_topk_ref(s, mask, k)
    rows, cols = s.shape
    vals = torch.empty((rows, k), dtype=torch.float32, device=s.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=s.device)
    _launch(build().bof_row_topk, s.device, vals.data_ptr(), idx.data_ptr(),
            s.data_ptr(), 0 if mask is None else mask.data_ptr(), rows,
            cols, k)
    if rows:
        row_topk.launches += 1
        row_topk.variant_launches[topk_variant(cols)] += 1
    return vals, idx


def reset_launch_counts() -> None:
    """Set B8's launch counts to 0."""
    row_topk.launches = 0
    row_topk.variant_launches = dict.fromkeys(TOPK_VARIANTS, 0)


reset_launch_counts()
