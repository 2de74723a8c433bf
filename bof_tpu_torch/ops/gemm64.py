"""float64 out-of-core GEMM under bof_tpu's name and signature.

bof_tpu's `gemm64` (`bof_tpu/ops/gemm64.py:265`) exists because a TPU has
no fp64 unit: it splits each float64 tile into int8 mantissa slices and
sums their exact products in int32 planes (Ozaki).  Hopper multiplies
float64 on its tensor cores, so here `gemm64` is `ops/gemm.py:gemm` on
float64 arrays, whose accumulate step is K1's 'f64' variant (DMMA).  The
emulation's knobs keep bof_tpu's contract: `slices` is range-checked as
bof_tpu checks it and otherwise has no effect (nothing is sliced), and
`k_flush` is accepted (there are no int32 planes to flush).  With
`mesh`, it is `parallel/mesh.py:gemm_sharded` on float64, K1 'f64' a
shard, as bof_tpu's mesh path is its sliced gemm sharded (whose Ozaki
slice steps, `_sharded_slice_accum`, have nothing to emulate here).
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
    computing.  `mesh` (a `DeviceMesh`, parallel.make_mesh) shards every
    superblock over its ranks (`gemm_sharded`)."""
    s = int(slices or 8)
    if not 2 <= s <= 12:
        raise ValueError(f"fp64_slices must be in [2, 12], got {s}")
    if not (a.dtype == b.dtype == c.dtype == np.float64):
        raise ValueError("gemm64 takes float64 arrays (gemm takes float32)")
    if mesh is not None:
        from ..parallel.mesh import gemm_sharded
        gemm_sharded(a, b, c, alpha=alpha, beta=beta, transa=transa,
                     transb=transb, blk=blk, mesh=mesh, ctx=ctx)
        return
    gemm(a, b, c, alpha=alpha, beta=beta, transa=transa, transb=transb,
         blk=blk, ctx=ctx)
