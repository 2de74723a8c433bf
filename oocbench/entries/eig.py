"""Entry `eig`: `bof_tpu_torch.apply_gram(A, V_c)`, U = A^T (A V_c), one
Krylov step of the block eigensolver.

A is the configuration's document-word matrix (docs x vocab, Zipf-skewed
tf-idf-like rows: `xml_rank.docs_csr`'s generator, values |N(0, 1)|) as
the `.off/.col/.csr` triplet, opened with `CsrFlashMatrix.map_files`
(O_DIRECT, the native engine).  The V_c are the mix's `v_cycle` panels
(vocab x block fp32), N(0, 1) drawn on the card from the seed and
orthonormalized there (float64 QR), held in host DRAM as the solver
holds its Krylov panel; call i takes V_{i mod v_cycle}, so a call that
hands back an earlier call's U fails.  U is a new (vocab x block)
float64 host array a call.

Each call judges the mix's `judged_words` rows of U: some of the most
frequent words of A (every document holds them: the longest sums) and
some drawn uniformly, against the float64 plain reference
(`oocbench/reference/gram.py`) on A as set-up wrote it, read back from
its files, and V_c drawn again from the seed.  A is not drawn again:
`docs_csr` on the card places a few of its words differently from one
draw to the next, and a frequent word's row sums every document, so one
misplaced word reads as an error of 1e-5 (PERF.md §2).
Each judged row is read divided by its own largest magnitude in the
program's U (kept a judged call; 1 for a row of zeros), and the want
divided by the same, so every word is judged at its own scale: judged
at the scale of the sample's largest row, a frequent word's sum over
half a million documents averages bf16's rounding down to within 10x
of fp32's (PERF.md §2).

A program without `apply_gram` cannot run the cell: `make` raises at
once, before anything is made.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import operands
from ..reference import gram
from .xml_rank import docs_csr

V_STREAM = 1  # V_c draws from stream V_STREAM + c; A from xml_rank's 0


def docs(cfg: dict, seed: int, device):
    """(ia, ja, va) of A: the test-set generator's, values made
    non-negative."""
    ia, ja, va = docs_csr(cfg, seed, device)
    return ia, ja, va.abs_()


def panel(cfg: dict, seed: int, c: int, device) -> torch.Tensor:
    """V_c: (vocab x block) N(0, 1) from the seed, orthonormal columns
    (float64 QR on `device`), as fp32."""
    v = operands.normals((cfg["vocab"], cfg["block"]), seed, V_STREAM + c,
                         device)
    q = torch.linalg.qr(v.to(torch.float64)).Q
    del v
    return q.to(torch.float32)


def make(run) -> dict:
    if not hasattr(run.port, "apply_gram"):
        raise RuntimeError(f"{run.port.__name__} has no apply_gram: "
                           "the program cannot run this cell")
    cfg = run.config
    ia, ja, va = docs(cfg, run.seed, run.device)
    prefix = run.a_prefix = os.path.join(run.dir, "A")
    nbytes = operands.write_csr(prefix, ia, ja, va)
    nnz = int(ja.numel())
    counts = torch.bincount(ja, minlength=cfg["vocab"])
    run.top_words = torch.topk(
        counts, run.mix["judged_words"]["of_top"]).indices.cpu().numpy()
    del ia, ja, va, counts
    v = [panel(cfg, run.seed, c, run.device).cpu().numpy()
         for c in range(run.mix["v_cycle"])]
    b = cfg["block"]
    return {"paths": {"A": prefix}, "v": v,
            "operand_bytes": nbytes,
            # a call pins A's columns and values once each, a row block's
            # at a time
            "pinned_bytes": 12 * nnz,
            # two products of 2 nnz b operations each
            "work": 4.0 * nnz * b,
            "shape": {"m": cfg["docs"], "k": cfg["vocab"], "n": b,
                      "nnz": nnz}}


def open_operands(run, made) -> dict:
    cfg = run.config
    a = run.port.CsrFlashMatrix.map_files(
        made["paths"]["A"], (cfg["docs"], cfg["vocab"]), ctx=run.ctx)
    run.kept_scale = {}   # call -> the judged rows' scales
    return {"A": a, "v": made["v"], "u": None, "last": None}


def call(run, ops, i: int) -> None:
    ops["u"] = None
    ops["u"] = run.port.apply_gram(ops["A"],
                                   ops["v"][i % run.mix["v_cycle"]],
                                   ctx=run.ctx)
    ops["last"] = i


def sample_shape(run) -> tuple:
    judged = run.mix["judged_words"]
    return (judged["frequent"] + judged["uniform"], run.config["block"])


def positions(run, rng) -> np.ndarray:
    """Rows of U: `frequent` of the `of_top` most frequent words, then
    `uniform` words drawn uniformly (distinct from those)."""
    judged = run.mix["judged_words"]
    top = rng.choice(run.top_words, judged["frequent"], replace=False)
    rest = rng.choice(run.config["vocab"],
                      judged["uniform"] + judged["frequent"], replace=False)
    rest = rest[~np.isin(rest, top)][:judged["uniform"]]
    return np.concatenate([top, rest])


def poison(run, ops, pos) -> None:
    """U is a new array a call; nothing of an earlier call's is reused."""


def read(run, ops, pos) -> np.ndarray:
    rows = np.asarray(ops["u"])[pos]
    scale = np.abs(rows).max(axis=1)
    scale[~(scale > 0)] = 1.0   # zeros; NaN rows fail on their own
    run.kept_scale[ops["last"]] = scale
    return rows / scale[:, None]


def written(prefix: str, device):
    """(ia, ja, va) of the `.off/.col/.csr` triplet at `prefix`, on
    `device`."""
    return tuple(torch.from_numpy(np.fromfile(prefix + ext, dt)).to(device)
                 for ext, dt in ((".off", np.int64), (".col", np.int64),
                                 (".csr", np.float32)))


def expected(run, calls) -> list:
    """U[words] of each judged call in float64, by the plain reference
    on A read back from set-up's files and V_{i mod v_cycle} drawn again
    from the seed."""
    cfg, cycle = run.config, run.mix["v_cycle"]
    ia, ja, va = written(run.a_prefix, run.device)
    out = [None] * len(calls)
    for c in range(cycle):
        mine = [j for j, (i, _) in enumerate(calls) if i % cycle == c]
        if not mine:
            continue
        words = np.unique(np.concatenate([calls[j][1] for j in mine]))
        v = panel(cfg, run.seed, c, run.device)
        rows = gram.gram_rows(ia, ja, va, v, words).cpu().numpy()
        del v
        for j in mine:
            i, pos = calls[j]
            out[j] = (rows[np.searchsorted(words, pos)]
                      / run.kept_scale[i][:, None])
    return out
