"""The plain reference of one-vs-rest XML inference: float64 label scores
and their top-k, in plain PyTorch.

It imports neither jax, nor bof_tpu, nor bof_tpu_torch, and is handed
only the operands the benchmark made (drawn again from the run's seed),
never anything the program made.  Scores are summed in float64 on
whatever device the tensors sit on, a block of nonzeros at a time, so
that W (labels x vocab, fp32) is never widened whole.
"""
from __future__ import annotations

import torch

TERM_BLOCK = 1 << 27  # float64 terms a block of nonzeros holds at a time


def scores(ia: torch.Tensor, ja: torch.Tensor, va: torch.Tensor,
           w: torch.Tensor, rows) -> torch.Tensor:
    """float64 (len(rows), labels) scores A[rows] W^T, for CSR A (int64
    ia/ja, float32 va) and w (labels, vocab) float32: each row is the sum
    over its nonzeros of va * W[:, ja], summed by index_add_."""
    dev = ia.device
    rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    lo, hi = ia[rows], ia[rows + 1]
    counts = hi - lo
    out = torch.zeros((len(rows), w.shape[0]), dtype=torch.float64,
                      device=dev)
    # the nonzeros of the selected rows, in order: their output row and
    # their position in ja/va
    out_row = torch.repeat_interleave(
        torch.arange(len(rows), dtype=torch.int64, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = (torch.repeat_interleave(lo, counts)
           + torch.arange(len(out_row), dtype=torch.int64, device=dev)
           - torch.repeat_interleave(first, counts))
    step = max(1, TERM_BLOCK // max(w.shape[0], 1))
    for s in range(0, len(pos), step):
        p = pos[s:s + step]
        terms = (w.index_select(1, ja[p]).T.to(torch.float64)
                 * va[p].to(torch.float64)[:, None])
        out.index_add_(0, out_row[s:s + step], terms)
    return out


def top_k(s: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest scores of each row of s, descending."""
    return torch.topk(s, k, dim=1).values
