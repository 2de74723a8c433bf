"""float64 out-of-core GEMM under bof_tpu's name and signature.

bof_tpu's `gemm64` (`bof_tpu/ops/gemm64.py:265`) exists because a TPU has
no fp64 unit: it splits each float64 tile into int8 mantissa slices and
sums their exact products in int32 planes (Ozaki).  Hopper multiplies
float64 on its tensor cores, so here `gemm64` is `ops/gemm.py:gemm` on
float64 arrays, whose accumulate step is K1's 'f64' variant (DMMA).  The
emulation's knobs keep bof_tpu's contract: `slices` is range-checked as
bof_tpu checks it and otherwise has no effect (nothing is sliced), and
`k_flush` is accepted (there are no int32 planes to flush).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .gemm import gemm


def gemm64(a, b, c, alpha: float = 1.0, beta: float = 0.0,
           transa: str = "N", transb: str = "N",
           blk: Optional[int] = None, ctx=None,
           slices: Optional[int] = None,
           k_flush: Optional[int] = None, mesh=None) -> None:
    """C = alpha*op(A)op(B) + beta*C for float64 flash arrays.  Shapes and
    layouts as `gemm`; `debug_checks` rejects a non-finite operand before
    computing.  `mesh` (multi-GPU) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError("gemm64 mesh= is not ported yet (ROADMAP "
                                  "A14: multi-GPU)")
    s = int(slices or 8)
    if not 2 <= s <= 12:
        raise ValueError(f"fp64_slices must be in [2, 12], got {s}")
    if not (a.dtype == b.dtype == c.dtype == np.float64):
        raise ValueError("gemm64 takes float64 arrays (gemm takes float32)")
    gemm(a, b, c, alpha=alpha, beta=beta, transa=transa, transb=transb,
         blk=blk, ctx=ctx)
