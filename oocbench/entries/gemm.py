"""Entry `gemm`: `bof_tpu_torch.gemm(A, B, C, alpha, beta, transa, transb)`.

A and B are raw fp32 files opened with `map_array` (O_DIRECT, the native
engine); C is a `mem_array` in host DRAM.  The configuration gives m, n,
k, the storage order, the transposes and alpha; beta is 0, so C's prior
contents are never read.  Each call scales alpha by its own factor drawn
from the seed (`call_alpha`), so no call's answer is an earlier call's.

Each judged call first writes NaN over its sampled rows of C, so a call
that leaves C as it was fails, and reads them back through C's store
once it returns.
"""
from __future__ import annotations

import os

import numpy as np

from .. import operands, reference

SAMPLE_ROWS = 16  # rows of C judged a call, drawn from the seed


def _shapes(cfg):
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    ta, tb = cfg["transa"] == "T", cfg["transb"] == "T"
    a_shape = (k, m) if ta else (m, k)
    b_shape = (n, k) if tb else (k, n)
    return a_shape, b_shape


def _storage(shape, order):
    return shape if order == "R" else (shape[1], shape[0])


def _logical_op(stored, order, trans):
    """op(X) as a view of X's storage-major tensor."""
    x = stored if order == "R" else stored.T
    return x.T if trans == "T" else x


def make(run) -> dict:
    cfg = run.config
    if cfg["beta"] != 0:
        raise ValueError("entry gemm judges beta == 0 only")
    a_shape, b_shape = _shapes(cfg)
    paths = {}
    for stream, (name, shape) in enumerate((("A", a_shape),
                                            ("B", b_shape))):
        x = operands.normals(_storage(shape, cfg["order"]), run.seed,
                             stream, run.device)
        paths[name] = os.path.join(run.dir, name + ".f32")
        operands.write_raw(paths[name], x)
        del x
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    blk = run.mix.get("flash_config", {}).get(
        "gemm_blk_size", run.port.FlashConfig().gemm_blk_size)
    tiles = -(-m // blk) * -(-k // blk) + -(-k // blk) * -(-n // blk)
    return {"paths": paths,
            "operand_bytes": 4 * (m * k + k * n),
            # a pin is one tile of A or B: their mean bytes, a whole
            # tile's where m, n and k are multiples of blk
            "pin_bytes": 4 * (m * k + k * n) // tiles,
            "work": 2.0 * m * n * k,
            "shape": {"m": m, "n": n, "k": k}}


def open_operands(run, made) -> dict:
    bt, cfg = run.port, run.config
    a_shape, b_shape = _shapes(cfg)
    order = cfg["order"]
    return {
        "A": bt.map_array(made["paths"]["A"], a_shape, np.float32, order,
                          ctx=run.ctx),
        "B": bt.map_array(made["paths"]["B"], b_shape, np.float32, order,
                          ctx=run.ctx),
        "C": bt.mem_array((cfg["m"], cfg["n"]), np.float32, order,
                          ctx=run.ctx),
    }


def call_alpha(run, i: int) -> float:
    """alpha of call `i` (the warm-up is -1): the configuration's alpha
    times a sign and a size in [0.5, 2) drawn from the seed, rounded to
    C's float32."""
    g = np.random.default_rng(np.random.SeedSequence([run.seed, 17, i + 1]))
    factor = g.choice((-1.0, 1.0)) * g.uniform(0.5, 2.0)
    return float(np.float32(run.config["alpha"] * factor))


def call(run, ops, i: int) -> None:
    cfg = run.config
    run.port.gemm(ops["A"], ops["B"], ops["C"], alpha=call_alpha(run, i),
                  beta=cfg["beta"], transa=cfg["transa"],
                  transb=cfg["transb"], ctx=run.ctx)


def sample_shape(run) -> tuple:
    return (min(SAMPLE_ROWS, run.config["m"]), run.config["n"])


def positions(run, rng) -> np.ndarray:
    n = run.config["m"]
    return np.sort(rng.choice(n, min(SAMPLE_ROWS, n), replace=False))


def poison(run, ops, pos) -> None:
    nan_row = np.full((1, run.config["n"]), np.nan, np.float32)
    for r in pos:
        ops["C"].write_block(int(r), nan_row)


def read(run, ops, pos) -> np.ndarray:
    c = ops["C"]
    return np.concatenate([c.read_block(int(r), 1) for r in pos])


def expected(run, calls) -> list:
    """alpha_i op(A)[rows] op(B) in float64 for each judged call i's
    rows, with A and B drawn again from the seed."""
    cfg = run.config
    a_shape, b_shape = _shapes(cfg)
    a = operands.normals(_storage(a_shape, cfg["order"]), run.seed, 0,
                         run.device)
    b = operands.normals(_storage(b_shape, cfg["order"]), run.seed, 1,
                         run.device)
    op_a = _logical_op(a, cfg["order"], cfg["transa"])
    op_b = _logical_op(b, cfg["order"], cfg["transb"])
    rows = np.unique(np.concatenate([pos for _, pos in calls]))
    want = reference.gemm_rows(op_a, op_b, rows).cpu().numpy()
    where = {int(r): j for j, r in enumerate(rows)}
    return [call_alpha(run, i) * want[[where[int(r)] for r in pos]]
            for i, pos in calls]
