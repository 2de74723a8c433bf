"""Entry `xml_rank`: `bof_tpu_torch.xml_rank(A_q, W, k)`, one-vs-rest top-k.

The configuration's test set (docs x vocab, Zipf-skewed tf-idf-like rows,
`docs_csr`) is cut into `QUARTERS` fixed row ranges, each written as its
own `.off/.col/.csr` triplet and opened with `CsrFlashMatrix.map_files`;
W is a raw (labels x vocab) row-major fp32 file opened with `map_array`
(both O_DIRECT, the native engine).  Call i scores quarter i mod 4 with
the port's default placement (the fused K2 + B8 path on the card), W in
label panels of the mix's `label_blk`, into the quarter's (rows x k)
scores and labels, `mem_array`s in host DRAM.  The warm-up scores every
quarter once, so every shape and every pin of the window is warm.

Each call judges `SAMPLE_DOCS` documents drawn from the seed: their
output rows in every quarter are first set to NaN scores and label -1,
then read back through the outputs' stores.  The sample is each
document's k scores twice; the want is the float64 reference's k best
scores, then the reference's scores at the k labels the program returned
(kept a judged call).  A wrong label fails; a near-tie that rounding
flips does not.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import operands
from ..reference import xml_ovr

QUARTERS = 4       # fixed row ranges of the test set, one a call in turn
SAMPLE_DOCS = 64   # documents judged a call, drawn from the seed
A_STREAM, W_STREAM = 0, 1
MAX_ROUNDS = 4096  # redraws of repeated columns before giving up


def bounds(docs: int) -> list:
    """The first row of each quarter, and the end."""
    return [q * docs // QUARTERS for q in range(QUARTERS + 1)]


def docs_csr(cfg: dict, seed: int, device):
    """(ia int64 (docs+1,), ja int64 (nnz,), va float32 (nnz,)) of the
    configuration's test set, drawn on `device` from the seed: row
    lengths log-normal (sigma `nnz_per_doc_sigma`, mean
    `nnz_per_doc_mean`), rounded and clipped to [1, `nnz_per_doc_max`];
    columns by a Zipf law (exponent `zipf_exponent`) over a seeded
    permutation of the ids, a column drawn again while it repeats in its
    row, then sorted within the row; values N(0, 1)."""
    gen = operands.generator(seed, A_STREAM, device)
    m, vocab = cfg["docs"], cfg["vocab"]
    sigma = cfg["nnz_per_doc_sigma"]
    mu = math.log(cfg["nnz_per_doc_mean"]) - sigma * sigma / 2
    z = torch.randn(m, generator=gen, device=device, dtype=torch.float64)
    lengths = torch.exp(mu + sigma * z).round_().clamp_(
        1, min(cfg["nnz_per_doc_max"], vocab)).to(torch.int64)
    perm = torch.randperm(vocab, generator=gen, device=device)
    cdf = torch.cumsum(torch.arange(1, vocab + 1, dtype=torch.float64,
                                    device=device)
                       .pow_(-cfg["zipf_exponent"]), 0)
    cdf /= cdf[-1].clone()

    def draw(n):
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
        return torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1)

    ia = torch.zeros(m + 1, dtype=torch.int64, device=device)
    torch.cumsum(lengths, 0, out=ia[1:])
    rows = torch.repeat_interleave(
        torch.arange(m, dtype=torch.int64, device=device), lengths)
    ranks = draw(len(rows))
    for _ in range(MAX_ROUNDS):
        # a stable sort keeps the first of equal (row, rank) pairs first:
        # the later ones are drawn again, the same ones on every device
        keys = rows * vocab + ranks
        order = torch.sort(keys, stable=True).indices
        sk = keys[order]
        again = order[1:][sk[1:] == sk[:-1]]
        if not len(again):
            break
        ranks[again] = draw(len(again))
    else:
        raise RuntimeError("a row kept a repeated column")
    keys = torch.sort(rows * vocab + perm[ranks]).values
    ja = keys - rows * vocab
    del keys, rows, ranks
    va = torch.randn(len(ja), generator=gen, device=device,
                     dtype=torch.float32)
    return ia, ja, va


def label_weights(cfg: dict, seed: int, device) -> torch.Tensor:
    return operands.normals((cfg["labels"], cfg["vocab"]), seed, W_STREAM,
                            device)


def make(run) -> dict:
    cfg, lb = run.config, run.mix["label_blk"]
    ia, ja, va = docs_csr(cfg, run.seed, run.device)
    b = bounds(cfg["docs"])
    a_paths, a_bytes = [], []
    for q in range(QUARTERS):
        i0, i1 = int(ia[b[q]]), int(ia[b[q + 1]])
        a_paths.append(os.path.join(run.dir, f"A{q}"))
        a_bytes.append(operands.write_csr(a_paths[-1],
                                          ia[b[q]:b[q + 1] + 1] - i0,
                                          ja[i0:i1], va[i0:i1]))
    nnz = int(ia[-1])
    del ia, ja, va
    w = label_weights(cfg, run.seed, run.device)
    w_path = os.path.join(run.dir, "W.f32")
    w_bytes = operands.write_raw(w_path, w)
    del w
    labels, panels = cfg["labels"], -(-cfg["labels"] // lb)
    # the means over the quarters: a window's calls take them in turn
    return {"paths": {"A": a_paths, "W": w_path},
            # one call's operands: W and a quarter of A
            "operand_bytes": w_bytes + max(a_bytes),
            # a call pins W's panels once and its quarter's columns and
            # values once a panel
            "pinned_bytes": w_bytes + panels * 12 * nnz // QUARTERS,
            "work": 2.0 * nnz * labels / QUARTERS,
            "shape": {"m": cfg["docs"] // QUARTERS, "k": cfg["vocab"],
                      "n": labels, "nnz": nnz // QUARTERS,
                      "label_blk": lb, "top_k": cfg["k"]}}


def open_operands(run, made) -> dict:
    bt, cfg = run.port, run.config
    b, k = bounds(cfg["docs"]), cfg["k"]
    quarters = []
    for q, prefix in enumerate(made["paths"]["A"]):
        rows = b[q + 1] - b[q]
        quarters.append((
            bt.CsrFlashMatrix.map_files(prefix, (rows, cfg["vocab"]),
                                        ctx=run.ctx),
            bt.mem_array((rows, k), np.float32, "R", ctx=run.ctx),
            bt.mem_array((rows, k), np.int32, "R", ctx=run.ctx)))
    run.kept_labels = {}   # call -> the judged documents' labels
    return {"quarters": quarters, "last": None,
            "W": bt.map_array(made["paths"]["W"],
                              (cfg["labels"], cfg["vocab"]), np.float32,
                              "R", ctx=run.ctx)}


def call(run, ops, i: int) -> None:
    for q in range(QUARTERS) if i < 0 else (i % QUARTERS,):
        a, scores, labels = ops["quarters"][q]
        run.port.xml_rank(a, ops["W"], run.config["k"], scores_out=scores,
                          labels_out=labels, label_blk=run.mix["label_blk"],
                          ctx=run.ctx)
    ops["last"] = i


def sample_shape(run) -> tuple:
    return (SAMPLE_DOCS, 2 * run.config["k"])


def positions(run, rng) -> np.ndarray:
    """Document rows within a quarter (the smallest quarter's range)."""
    b = bounds(run.config["docs"])
    n = min(b[q + 1] - b[q] for q in range(QUARTERS))
    return np.sort(rng.choice(n, min(SAMPLE_DOCS, n), replace=False))


def poison(run, ops, pos) -> None:
    k = run.config["k"]
    nan_row = np.full((1, k), np.nan, np.float32)
    bad_row = np.full((1, k), -1, np.int32)
    for _, scores, labels in ops["quarters"]:
        for r in pos:
            scores.write_block(int(r), nan_row)
            labels.write_block(int(r), bad_row)


def read(run, ops, pos) -> np.ndarray:
    i = ops["last"]
    _, scores, labels = ops["quarters"][i % QUARTERS]
    got = np.concatenate([scores.read_block(int(r), 1) for r in pos])
    run.kept_labels[i] = np.concatenate([labels.read_block(int(r), 1)
                                         for r in pos])
    return np.concatenate([got, got], axis=1)


def expected(run, calls) -> list:
    """For each judged call i, at its documents of quarter i mod 4: the
    float64 reference's k best scores, then its scores at the labels the
    program returned (NaN at a label outside [0, labels)), with A and W
    drawn again from the seed."""
    cfg, k = run.config, run.config["k"]
    ia, ja, va = docs_csr(cfg, run.seed, run.device)
    w = label_weights(cfg, run.seed, run.device)
    b = bounds(cfg["docs"])
    out = [None] * len(calls)
    for q in range(QUARTERS):
        mine = [c for c, (i, _) in enumerate(calls) if i % QUARTERS == q]
        if not mine:
            continue
        rows = np.unique(np.concatenate([calls[c][1] for c in mine]))
        s = xml_ovr.scores(ia, ja, va, w, rows + b[q])
        best = xml_ovr.top_k(s, k).cpu().numpy()
        s = s.cpu().numpy()
        where = {int(r): j for j, r in enumerate(rows)}
        for c in mine:
            i, pos = calls[c]
            at = [where[int(r)] for r in pos]
            lab = run.kept_labels[i].astype(np.int64)
            ok = (lab >= 0) & (lab < cfg["labels"])
            got_at = np.where(ok, s[np.array(at)[:, None],
                                    np.clip(lab, 0, cfg["labels"] - 1)],
                              np.nan)
            out[c] = np.concatenate([best[at], got_at], axis=1)
    return out
