"""The plain reference of the A^T A operator of a block eigensolver:
float64 rows of U = A^T (A V), in plain PyTorch.

It imports neither jax, nor bof_tpu, nor bof_tpu_torch, and is handed
only the operands the benchmark made (drawn again from the run's seed),
never anything the program made.  Both products are summed in float64 on
whatever device the tensors sit on, a block of nonzeros at a time (W by
`oocbench.reference.csr_rows_times`).  Nothing here is a matrix product,
but a reference states TF32 off all the same.
"""
from __future__ import annotations

import torch

from . import csr_rows_times

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TERM_BLOCK = 1 << 27  # float64 terms a block of nonzeros holds at a time


def gram_rows(ia: torch.Tensor, ja: torch.Tensor, va: torch.Tensor,
              v: torch.Tensor, words) -> torch.Tensor:
    """float64 (len(words), b) rows U[words] of U = A^T (A V), for CSR A
    (int64 ia/ja, float32 va) and v (vocab, b) float32:
    U[j] = sum_i A_ij (A_i . V), over the documents i that hold word j.
    W_i = A_i . V is taken for those documents alone, then each of their
    nonzeros in a judged word adds A_ij W_i to its row, by index_add_."""
    dev = ia.device
    words = torch.as_tensor(words, dtype=torch.int64, device=dev)
    judged, slot = torch.unique(words, return_inverse=True)
    hit = torch.isin(ja, judged).nonzero().squeeze(1)
    doc = torch.searchsorted(ia, hit, right=True) - 1
    docs, at = torch.unique(doc, return_inverse=True)
    w = csr_rows_times(ia, ja, va, v, docs)       # (len(docs), b) float64
    out = torch.zeros((len(judged), v.shape[1]), dtype=torch.float64,
                      device=dev)
    row = torch.searchsorted(judged, ja[hit])
    step = max(1, TERM_BLOCK // max(v.shape[1], 1))
    for s in range(0, len(hit), step):
        terms = (va[hit[s:s + step]].to(torch.float64)[:, None]
                 * w[at[s:s + step]])
        out.index_add_(0, row[s:s + step], terms)
    return out[slot]


def svdvals(ia: torch.Tensor, ja: torch.Tensor, va: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """Every singular value of a small CSR A (docs x vocab), descending:
    torch.linalg.svdvals of A densified in float64."""
    rows = torch.repeat_interleave(
        torch.arange(len(ia) - 1, device=ia.device), ia.diff())
    a = torch.zeros((len(ia) - 1, vocab), dtype=torch.float64,
                    device=ia.device)
    a[rows, ja] = va.to(torch.float64)
    return torch.linalg.svdvals(a)
