"""Entry `csrgemv`: `bof_tpu_torch.csrgemv(A, x, "N")`, y returned in DRAM.

A is the configuration's CSR matrix as the `.off/.col/.csr` triplet
(int64 offsets and columns, fp32 values), opened with
`CsrFlashMatrix.map_files` (O_DIRECT, the native engine).  x and y are
host vectors, the port's contract for csrgemv.  Calls cycle through
`X_CYCLE` vectors x ~ N(0, 1) made at set-up, so a call that hands back
an earlier call's y fails.
"""
from __future__ import annotations

import os

import numpy as np

from .. import operands, reference

X_CYCLE = 4          # distinct x vectors, used in turn
SAMPLE_ENTRIES = 16384  # entries of y judged a call, drawn from the seed


def make(run) -> dict:
    cfg = run.config
    m, k = cfg["rows"], cfg["cols"]
    ia, ja, va = operands.csr_uniform(m, k, cfg["density"], run.seed, 0,
                                      run.device)
    prefix = os.path.join(run.dir, "A")
    nbytes = operands.write_csr(prefix, ia, ja, va)
    nnz = int(ja.numel())
    del ia, ja, va
    x = operands.normals((X_CYCLE, k), run.seed, 1, run.device)
    return {"paths": {"A": prefix}, "x": x.cpu().numpy(),
            "operand_bytes": nbytes,
            # a call pins A's columns and values once each, a row block's
            # at a time
            "pinned_bytes": 12 * nnz,
            "work": 2.0 * nnz,
            "shape": {"m": m, "k": k, "n": 1, "nnz": nnz}}


def open_operands(run, made) -> dict:
    cfg = run.config
    a = run.port.CsrFlashMatrix.map_files(
        made["paths"]["A"], (cfg["rows"], cfg["cols"]), ctx=run.ctx)
    return {"A": a, "x": made["x"], "y": None}


def call(run, ops, i: int) -> None:
    ops["y"] = None
    ops["y"] = run.port.csrgemv(ops["A"], ops["x"][i % X_CYCLE], "N",
                                ctx=run.ctx)


def sample_shape(run) -> tuple:
    return (min(SAMPLE_ENTRIES, run.config["rows"]),)


def positions(run, rng) -> np.ndarray:
    n = run.config["rows"]
    return np.sort(rng.choice(n, min(SAMPLE_ENTRIES, n), replace=False))


def poison(run, ops, pos) -> None:
    """y is a new array a call; nothing of an earlier call's is reused."""


def read(run, ops, pos) -> np.ndarray:
    return np.asarray(ops["y"])[pos]


def expected(run, calls) -> list:
    """A x_j in float64 for each of the X_CYCLE vectors, with A and x
    drawn again from the seed, at each judged call's entries."""
    cfg = run.config
    ia, ja, va = operands.csr_uniform(cfg["rows"], cfg["cols"],
                                      cfg["density"], run.seed, 0,
                                      run.device)
    x = operands.normals((X_CYCLE, cfg["cols"]), run.seed, 1, run.device)
    want = reference.csr_rows_times(ia, ja, va, x.T.contiguous())
    del ia, ja, va
    want = want.cpu().numpy()
    return [want[pos, i % X_CYCLE] for i, pos in calls]
