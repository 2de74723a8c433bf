"""The port's out-of-core gemm against bof_tpu's, on the same files.

Each case writes A, B and a starting C once from a seeded numpy
generator, runs `bof_tpu.gemm` and `bof_tpu_torch.gemm` (device "cpu",
the plain version of K1) over them under one configuration carried across
by `config_from_reference`, and compares the two C files at the repo's
fp32 tolerance (rtol 2e-4, atol 1e-4, as tests/test_gemm.py), plus the
float64 golden.  The transfer modes (bf16/int8 A and B, a bf16 C
download) round the same inputs the same way in both packages, so they are
held to the fp32 invariant as well (2e-4 of max|C|), or to one bf16 ulp an
element where C comes down as bf16, and to bof_tpu's bands against
float64.  Tiny superblocks make every case multi-block: padding,
accumulate chains, the group schedule and write-back all run.
"""
import dataclasses
import itertools
import os

import numpy as np
import pytest

import bof_tpu
import bof_tpu_torch
from bof_tpu.ops.gemm import _journal_header as ref_journal_header
from bof_tpu_torch.ops.gemm import _journal_header as port_journal_header
from bof_tpu_torch.utils import METRICS

F32 = np.float32


def _configs(tmp_path, **kw):
    ref = bof_tpu.FlashConfig(scratch_dir=str(tmp_path / "scratch"),
                              n_io_threads=4, n_compute_threads=2,
                              program_budget=256 << 20, **kw)
    port = bof_tpu_torch.config_from_reference(dataclasses.asdict(ref),
                                               device="cpu")
    return ref, port


def _write(path, data, order):
    np.ascontiguousarray(data if order == "R" else data.T).tofile(path)


def _read(path, shape, order):
    st = shape if order == "R" else shape[::-1]
    x = np.fromfile(path, F32).reshape(st)
    return x if order == "R" else x.T


def _run(pkg, cfg, paths, shapes, order, c_path, **gemm_kw):
    ctx = pkg.FlashContext(cfg)
    try:
        arrs = [pkg.map_array(p, s, F32, order, ctx=ctx)
                for p, s in zip(paths, shapes)]
        arrs.append(pkg.map_array(c_path, shapes[2], F32, order, ctx=ctx))
        pkg.gemm(*arrs, ctx=ctx, **gemm_kw)
    finally:
        ctx.destroy()


def run_both(tmp_path, order="R", ta="N", tb="N", m=37, n=29, k=41, blk=16,
             alpha=1.5, beta=0.0, seed=0, **cfg_kw):
    """Both packages on the same A/B/C files; returns (ref C, port C,
    golden C) as logical float32 arrays."""
    rng = np.random.default_rng(seed)
    a_shape = (k, m) if ta == "T" else (m, k)
    b_shape = (n, k) if tb == "T" else (k, n)
    a = rng.standard_normal(a_shape).astype(F32)
    b = rng.standard_normal(b_shape).astype(F32)
    c0 = rng.standard_normal((m, n)).astype(F32)
    d = str(tmp_path)
    a_path, b_path = os.path.join(d, "A.bin"), os.path.join(d, "B.bin")
    _write(a_path, a, order)
    _write(b_path, b, order)
    c_paths = {}
    for name in ("ref", "port"):
        c_paths[name] = os.path.join(d, f"C_{name}.bin")
        _write(c_paths[name], c0, order)
    ref_cfg, port_cfg = _configs(tmp_path, **cfg_kw)
    kw = dict(alpha=alpha, beta=beta, transa=ta, transb=tb, blk=blk)
    shapes = (a_shape, b_shape, (m, n))
    _run(bof_tpu, ref_cfg, (a_path, b_path), shapes, order, c_paths["ref"],
         **kw)
    _run(bof_tpu_torch, port_cfg, (a_path, b_path), shapes, order,
         c_paths["port"], **kw)
    opa = (a.T if ta == "T" else a).astype(np.float64)
    opb = (b.T if tb == "T" else b).astype(np.float64)
    golden = alpha * (opa @ opb) + beta * c0.astype(np.float64)
    return (_read(c_paths["ref"], (m, n), order),
            _read(c_paths["port"], (m, n), order), golden.astype(F32))


def _check(got_ref, got_port, golden):
    np.testing.assert_allclose(got_port, got_ref, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got_port, golden, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("order,ta,tb",
                         list(itertools.product("RC", "NT", "NT")))
def test_all_eight_configs_match_reference(tmp_path, order, ta, tb):
    _check(*run_both(tmp_path, order, ta, tb))


def test_ragged_tiny_blk(tmp_path):
    _check(*run_both(tmp_path, "C", "N", "T", m=50, n=23, k=19, blk=8))


def test_beta_accumulate(tmp_path):
    _check(*run_both(tmp_path, "R", "T", "N", alpha=0.75, beta=0.6))


def test_small_device_budget_groups_and_evicts(tmp_path):
    """hbm_budget=1 forces G=1 < nB groups and an LRU that evicts every
    tile: tiles cross host->device more often than there are tiles."""
    m, n, k, blk = 48, 64, 40, 16
    METRICS.reset()
    _check(*run_both(tmp_path, "R", "N", "N", m=m, n=n, k=k, blk=blk,
                     beta=0.4, hbm_budget=1, pipeline_depth=2))
    kb = -(-k // blk)
    n_tiles = (m // blk) * kb + kb * (n // blk)
    # both packages count misses in their own METRICS; the port's alone
    # must exceed the distinct tile count
    assert METRICS.get("hbm.miss") > n_tiles


@pytest.mark.parametrize("io_backend", ["native", "python"])
def test_io_backends(tmp_path, io_backend):
    _check(*run_both(tmp_path, "R", "N", "T", m=60, n=44, k=52,
                     io_backend=io_backend))


def test_gemm_in_mem_twin_matches_reference():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((33, 21)).astype(F32)
    b = rng.standard_normal((19, 21)).astype(F32)
    c = rng.standard_normal((33, 19)).astype(F32)
    want = bof_tpu.gemm_in_mem(a, b, c, alpha=1.25, beta=0.5, transb="T")
    got = bof_tpu_torch.gemm_in_mem(a, b, c, alpha=1.25, beta=0.5,
                                    transb="T", device="cpu")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("transa,transb", [("N", "N"), ("T", "N"),
                                           ("N", "T"), ("T", "T")])
def test_gemm_in_mem_every_precision_matches_reference(prec, transa, transb):
    """bof_tpu's signature, `prec` passed by position as its in-memory
    drivers pass it: full fp32 on the CPU at every tier, as bof_tpu's dot
    is on a CPU (rtol 2e-4, the repo's fp32 invariant)."""
    rng = np.random.default_rng(6)
    m, n, k = 45, 27, 38
    a = rng.standard_normal((k, m) if transa == "T" else (m, k)).astype(F32)
    b = rng.standard_normal((n, k) if transb == "T" else (k, n)).astype(F32)
    c = rng.standard_normal((m, n)).astype(F32)
    want = bof_tpu.gemm_in_mem(a, b, c, 0.75, -1.5, transa, transb, prec)
    got = bof_tpu_torch.gemm_in_mem(a, b, c, 0.75, -1.5, transa, transb,
                                    prec, device="cpu")
    assert got.dtype == want.dtype == F32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


def test_gemm_in_mem_unknown_precision_raises():
    a = np.ones((4, 4), F32)
    with pytest.raises(ValueError, match="precision"):
        bof_tpu_torch.gemm_in_mem(a, a, prec="fastest", device="cpu")


def test_gemm_in_mem_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """`device` is keyword-only and defaults to the card: without one the
    call raises instead of running on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.ones((4, 4), F32)
    with pytest.raises(RuntimeError, match="is_available"):
        bof_tpu_torch.gemm_in_mem(a, a)
    with pytest.raises(TypeError):
        bof_tpu_torch.gemm_in_mem(a, a, None, 1.0, 0.0, "N", "N", "highest",
                                  "cpu")
    np.testing.assert_allclose(bof_tpu_torch.gemm_in_mem(a, a, device="cpu"),
                               np.full((4, 4), 4.0, F32))


def test_resume_journal_is_the_reference_format_and_byte_identical(
        tmp_path):
    """A journal written by a killed run names its problem with the same
    header in both packages; resuming from it (here: the first two C
    superblocks already durable) gives the uninterrupted run's bytes."""
    n, blk = 64, 16
    rng = np.random.default_rng(11)
    a = rng.standard_normal((n, n)).astype(F32)
    b = rng.standard_normal((n, n)).astype(F32)
    d = str(tmp_path)
    paths = {x: os.path.join(d, f"{x}.bin") for x in ("A", "B")}
    _write(paths["A"], a, "R")
    _write(paths["B"], b, "R")
    _, cfg = _configs(tmp_path)
    header = port_journal_header(n, n, n, 1.0, 0.0, "N", "N", blk,
                                 np.dtype(F32), "float32")
    assert header == ref_journal_header(n, n, n, 1.0, 0.0, "N", "N", blk,
                                        np.dtype(F32), "float32")

    full = os.path.join(d, "C_full.bin")
    np.zeros((n, n), F32).tofile(full)
    journal = os.path.join(d, "journal.txt")
    shapes = ((n, n), (n, n), (n, n))
    _run(bof_tpu_torch, cfg, (paths["A"], paths["B"]), shapes, "R", full,
         blk=blk, resume_journal=journal)
    assert not os.path.exists(journal), "a finished run removes its journal"
    want = np.fromfile(full, F32)

    # an interrupted run: blocks (0,0) and (0,1) durable, the rest not
    resumed = os.path.join(d, "C_resumed.bin")
    c = np.full((n, n), np.nan, F32)
    c[:blk, :2 * blk] = want.reshape(n, n)[:blk, :2 * blk]
    c.tofile(resumed)
    with open(journal, "w") as f:
        f.write(header + "\n0 0\n0 1\n")
    METRICS.reset()
    _run(bof_tpu_torch, cfg, (paths["A"], paths["B"]), shapes, "R", resumed,
         blk=blk, resume_journal=journal)
    assert not os.path.exists(journal)
    assert METRICS.get("gemm.d2h_bytes") == (n * n - 2 * blk * blk) * 4, \
        "the journaled blocks are skipped"
    np.testing.assert_array_equal(np.fromfile(resumed, F32), want)


# bof_tpu's bands for each mode against float64 (tests/test_gemm.py):
# bf16 inputs 2e-2 of max|C|, int8 inputs 5e-2, a bf16 C download 1e-2
BANDS = {("bfloat16", "float32"): 2e-2, ("int8", "float32"): 5e-2,
         ("float32", "bfloat16"): 1e-2, ("int8", "bfloat16"): 5e-2}
MODES = list(BANDS)


def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, e - 8)


def check_mode(ref, port, golden, xfer, c_xfer):
    """The port against bof_tpu in a transfer mode: the fp32 invariant
    (2e-4 of max|C|), or one bf16 ulp an element where C came down as
    bf16 (a different fp32 summation order may round to the neighbouring
    bf16 value); and both inside bof_tpu's band against float64, yet off
    it: the mode really rounded."""
    if c_xfer == "bfloat16":
        ulp = bf16_ulp(np.maximum(np.abs(ref), np.abs(port)))
        assert (np.abs(port.astype(np.float64) - ref) <= ulp).all()
    else:
        np.testing.assert_allclose(port, ref, rtol=0,
                                   atol=2e-4 * np.abs(ref).max())
    for got in (ref, port):
        rel = np.abs(got.astype(np.float64) - golden).max() \
            / np.abs(golden).max()
        assert 1e-6 < rel < BANDS[(xfer, c_xfer)], rel


@pytest.mark.parametrize("field,value", [
    ("transfer_dtype", "bfloat16"), ("transfer_dtype", "int8"),
    ("c_transfer_dtype", "bfloat16")])
def test_unported_transfer_modes_raise(tmp_path, field, value):
    """Each transfer mode that was refused before it was ported now runs,
    and matches bof_tpu on the same files (beta != 0, ragged blocks).
    The name dates from the refusal and is kept so the cases' history
    reads on."""
    modes = {"transfer_dtype": "float32", "c_transfer_dtype": "float32",
             field: value}
    ref, port, golden = run_both(tmp_path, "R", "T", "N", beta=0.5,
                                 **modes)
    check_mode(ref, port, golden, modes["transfer_dtype"],
               modes["c_transfer_dtype"])


@pytest.mark.parametrize("xfer,c_xfer", MODES)
@pytest.mark.parametrize("order,ta,tb",
                         list(itertools.product("RC", "NT", "NT")))
def test_transfer_modes_all_eight_configs(tmp_path, order, ta, tb, xfer,
                                          c_xfer):
    """Every mode, and int8 with a bf16 C download (bof_tpu's bench mode),
    on all 8 layouts with a ragged blk, alpha != 1 and beta != 0."""
    ref, port, golden = run_both(tmp_path, order, ta, tb, m=45, n=31, k=38,
                                 blk=12, alpha=0.75, beta=0.5,
                                 transfer_dtype=xfer, c_transfer_dtype=c_xfer)
    check_mode(ref, port, golden, xfer, c_xfer)


def test_transfer_modes_cross_the_link_in_fewer_bytes(tmp_path):
    """gemm.h2d_bytes of the A/B tiles is 1/2 (bf16) or 1/4 (int8) of the
    fp32 run's (beta 0: no C upload), and gemm.d2h_bytes is halved by the
    bf16 C download; the step plan is the fp32 one in every mode."""
    seen = {}
    for xfer, c_xfer in (("float32", "float32"),) + tuple(MODES):
        METRICS.reset()
        d = tmp_path / f"{xfer}_{c_xfer}"
        d.mkdir()
        run_both(d, "R", "N", "N", m=40, n=36,
                 k=44, blk=16, transfer_dtype=xfer, c_transfer_dtype=c_xfer)
        seen[(xfer, c_xfer)] = (METRICS.get("gemm.h2d_bytes"),
                                METRICS.get("gemm.d2h_bytes"),
                                METRICS.get("hbm.miss"))
    h2d, d2h, miss = seen[("float32", "float32")]
    assert d2h == 40 * 36 * 4
    for (xfer, c_xfer), got in seen.items():
        size = {"float32": 4, "bfloat16": 2, "int8": 1}[xfer]
        assert got[0] * 4 == h2d * size, (xfer, got)
        assert got[1] == d2h // (2 if c_xfer == "bfloat16" else 1)
        assert got[2] == miss


def test_transfer_mode_needs_float32_operands(tmp_path):
    """bof_tpu's ValueErrors for a transfer mode on other operands, float64
    included (bof_tpu/ops/gemm.py:214-219)."""
    for field in ("transfer_dtype", "c_transfer_dtype"):
        value = "int8" if field == "transfer_dtype" else "bfloat16"
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device="cpu", scratch_dir=str(tmp_path / "s"), **{field: value}))
        try:
            for dt, err in ((np.float16, ValueError),
                            (np.float64, ValueError)):
                a = bof_tpu_torch.mem_array((8, 8), dt, ctx=ctx)
                c = bof_tpu_torch.mem_array((8, 8), dt, ctx=ctx)
                with pytest.raises(err):
                    bof_tpu_torch.gemm(a, a, c, blk=4, ctx=ctx)
        finally:
            ctx.destroy()


def test_float64_raises(tmp_path):
    """float64 was refused until K1 'f64' was ported; the name dates from
    the refusal.  Now float64 runs (tests/test_torch_gemm64.py holds it to
    bof_tpu) and only other dtypes raise NotImplementedError."""
    ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
        device="cpu", scratch_dir=str(tmp_path / "s")))
    try:
        a = bof_tpu_torch.mem_array((8, 8), np.float64, ctx=ctx,
                                    data=np.eye(8) * 2.0)
        c = bof_tpu_torch.mem_array((8, 8), np.float64, ctx=ctx)
        bof_tpu_torch.gemm(a, a, c, blk=4, ctx=ctx)
        np.testing.assert_array_equal(c.read_all(), np.eye(8) * 4.0)
        h = bof_tpu_torch.mem_array((8, 8), np.float16, ctx=ctx)
        hc = bof_tpu_torch.mem_array((8, 8), np.float16, ctx=ctx)
        with pytest.raises(NotImplementedError, match="float32 and float64"):
            bof_tpu_torch.gemm(h, h, hc, blk=4, ctx=ctx)
    finally:
        ctx.destroy()


def test_driver_cli_runs_on_cpu(tmp_path, capsys):
    """python -m bof_tpu_torch.drivers.gemm, as a user runs it."""
    from bof_tpu_torch.drivers import gemm as driver
    rng = np.random.default_rng(2)
    m, n, k = 40, 30, 20
    a = rng.standard_normal((m, k)).astype(F32)
    b = rng.standard_normal((k, n)).astype(F32)
    d = str(tmp_path)
    for name, x in (("A", a), ("B", b)):
        x.tofile(os.path.join(d, f"{name}.bin"))
    c_path = os.path.join(d, "C.bin")
    secs = driver.main([os.path.join(d, "A.bin"), os.path.join(d, "B.bin"),
                        c_path, str(m), str(n), str(k), "--blk", "16",
                        "--create-c", "--device", "cpu",
                        "--scratch", os.path.join(d, "s")])
    assert secs > 0
    assert "checksum" in capsys.readouterr().out
    np.testing.assert_allclose(np.fromfile(c_path, F32).reshape(m, n),
                               a.astype(np.float64) @ b, rtol=2e-4,
                               atol=1e-4)
