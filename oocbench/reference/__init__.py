"""The plain reference: float64 products in plain PyTorch.

It imports neither jax, nor bof_tpu, nor bof_tpu_torch, and is handed
only the operands the benchmark made (drawn again from the run's seed by
`oocbench.operands`), never anything the program made.  Every product is
taken in float64 on whatever device the tensors sit on, in blocks so
that it fits.
"""
from __future__ import annotations

import torch

ROW_BLOCK = 256       # rows of A a dense block product takes at a time
TERM_BLOCK = 1 << 27  # float64 terms a sparse segment sum holds at a time


def gemm_rows(a: torch.Tensor, b: torch.Tensor, rows,
              alpha: float = 1.0) -> torch.Tensor:
    """alpha * A[rows] @ B in float64; a (m, k), b (k, n) float32."""
    rows = torch.as_tensor(rows, dtype=torch.int64, device=a.device)
    b64 = b.to(torch.float64)
    out = torch.empty((len(rows), b.shape[1]), dtype=torch.float64,
                      device=a.device)
    for r0 in range(0, len(rows), ROW_BLOCK):
        sel = rows[r0:r0 + ROW_BLOCK]
        out[r0:r0 + len(sel)] = a.index_select(0, sel).to(torch.float64) @ b64
    return out * alpha


def csr_rows_times(ia: torch.Tensor, ja: torch.Tensor, va: torch.Tensor,
                   b: torch.Tensor, rows=None) -> torch.Tensor:
    """(A @ B)[rows] in float64 for CSR A (int64 ia/ja, float32 va) and a
    dense b (k, n), or b (k,) for a vector; every row when `rows` is
    None.  Each row is the sum of its nonzeros' va * b[ja], summed by
    index_add_ in blocks of nonzeros."""
    vec = b.dim() == 1
    b64 = b.to(torch.float64).reshape(b.shape[0], -1)
    dev = ia.device
    if rows is None:
        lo, hi = ia[:-1], ia[1:]
    else:
        rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        lo, hi = ia[rows], ia[rows + 1]
    counts = hi - lo
    n_out = len(counts)
    out = torch.zeros((n_out, b64.shape[1]), dtype=torch.float64,
                      device=dev)
    # the nonzeros of the selected rows, in order: their output row and
    # their position in ja/va
    out_row = torch.repeat_interleave(
        torch.arange(n_out, dtype=torch.int64, device=dev), counts)
    starts = torch.repeat_interleave(lo, counts)
    first = torch.cumsum(counts, 0) - counts
    pos = starts + (torch.arange(len(out_row), dtype=torch.int64,
                                 device=dev)
                    - torch.repeat_interleave(first, counts))
    step = max(1, TERM_BLOCK // b64.shape[1])
    for s in range(0, len(pos), step):
        p = pos[s:s + step]
        terms = va[p].to(torch.float64)[:, None] * b64.index_select(0, ja[p])
        out.index_add_(0, out_row[s:s + step], terms)
    return out[:, 0] if vec else out
