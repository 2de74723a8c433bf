"""Entry `csrmm`: `bof_tpu_torch.csrmm(A, B, C)`, op(A) = A, alpha 1, beta 0.

A is the configuration's CSR triplet (as in entry `csrgemv`), B a raw
row-major fp32 file of k x `rhs_cols` (the mix's width) opened with
`map_array`, C a `mem_array` in host DRAM.  Calls cycle through
`B_CYCLE` such files made at set-up, so a call that hands back an
earlier call's C fails.  Each judged call first writes NaN over its
sampled rows of C and reads them back through C's store once it
returns.
"""
from __future__ import annotations

import os

import numpy as np

from .. import operands, reference

SAMPLE_ROWS = 256  # rows of C judged a call, drawn from the seed
B_CYCLE = 4        # distinct B files, used in turn


def make(run) -> dict:
    cfg, n = run.config, run.mix["rhs_cols"]
    m, k = cfg["rows"], cfg["cols"]
    ia, ja, va = operands.csr_uniform(m, k, cfg["density"], run.seed, 0,
                                      run.device)
    prefix = os.path.join(run.dir, "A")
    nbytes = operands.write_csr(prefix, ia, ja, va)
    nnz = int(ja.numel())
    del ia, ja, va
    b_paths = []
    for j in range(B_CYCLE):
        b = operands.normals((k, n), run.seed, 1 + j, run.device)
        b_paths.append(os.path.join(run.dir, f"B{j}.f32"))
        b_bytes = operands.write_raw(b_paths[-1], b)
        del b
    # one call's operands: A and one B (the Program Cache's share of them)
    return {"paths": {"A": prefix, "B": b_paths},
            "operand_bytes": nbytes + b_bytes,
            # a call pins A's columns and values once each, a row block's
            # at a time
            "pinned_bytes": 12 * nnz,
            "work": 2.0 * nnz * n,
            "shape": {"m": m, "k": k, "n": n, "nnz": nnz}}


def open_operands(run, made) -> dict:
    bt, cfg, n = run.port, run.config, run.mix["rhs_cols"]
    m, k = cfg["rows"], cfg["cols"]
    return {
        "A": bt.CsrFlashMatrix.map_files(made["paths"]["A"], (m, k),
                                         ctx=run.ctx),
        "B": [bt.map_array(path, (k, n), np.float32, "R", ctx=run.ctx)
              for path in made["paths"]["B"]],
        "C": bt.mem_array((m, n), np.float32, "R", ctx=run.ctx),
    }


def call(run, ops, i: int) -> None:
    run.port.csrmm(ops["A"], ops["B"][i % B_CYCLE], ops["C"], alpha=1.0,
                   beta=0.0,
                   transa="N", ctx=run.ctx)


def sample_shape(run) -> tuple:
    return (min(SAMPLE_ROWS, run.config["rows"]), run.mix["rhs_cols"])


def positions(run, rng) -> np.ndarray:
    n = run.config["rows"]
    return np.sort(rng.choice(n, min(SAMPLE_ROWS, n), replace=False))


def poison(run, ops, pos) -> None:
    nan_row = np.full((1, run.mix["rhs_cols"]), np.nan, np.float32)
    for r in pos:
        ops["C"].write_block(int(r), nan_row)


def read(run, ops, pos) -> np.ndarray:
    c = ops["C"]
    return np.concatenate([c.read_block(int(r), 1) for r in pos])


def expected(run, calls) -> list:
    """(A B_i)[rows] in float64 at each judged call i's rows, B_i the B
    file call i used, with A and the Bs drawn again from the seed."""
    cfg, n = run.config, run.mix["rhs_cols"]
    ia, ja, va = operands.csr_uniform(cfg["rows"], cfg["cols"],
                                      cfg["density"], run.seed, 0,
                                      run.device)
    out = [None] * len(calls)
    for j in range(B_CYCLE):
        mine = [c for c, (i, _) in enumerate(calls) if i % B_CYCLE == j]
        if not mine:
            continue
        b = operands.normals((cfg["cols"], n), run.seed, 1 + j, run.device)
        rows = np.unique(np.concatenate([calls[c][1] for c in mine]))
        want = reference.csr_rows_times(ia, ja, va, b, rows).cpu().numpy()
        where = {int(r): w for w, r in enumerate(rows)}
        for c in mine:
            out[c] = want[[where[int(r)] for r in calls[c][1]]]
    return out
