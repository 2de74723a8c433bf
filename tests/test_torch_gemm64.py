"""The port's float64 gemm (K1 'f64' on the card, its float64 plain version
here) against bof_tpu's `gemm64` and numpy float64, on the same files.

bof_tpu runs float64 through Ozaki int8 slicing (`fp64_device='sliced'`,
no JAX x64 needed, so nothing here turns x64 on: test workers are shared
across files).  Both packages must land within bof_tpu's scaled bound
(tests/test_gemm64.py:76-80): |C - C64| / (k * max|row of op(A)| *
max|column of op(B)|) below 1e-12, C64 the numpy float64 golden.  The port
is held to the bound against bof_tpu too, and to bit-identity where only
its own arithmetic is involved (zero blocks, a resumed run).
"""
import dataclasses
import inspect
import itertools
import os

import numpy as np
import pytest

import bof_tpu
import bof_tpu_torch
from bof_tpu.ops.gemm import _journal_header as ref_journal_header
from bof_tpu.ops.gemm64 import gemm64 as ref_gemm64
from bof_tpu_torch.ops.gemm import _journal_header as port_journal_header
from bof_tpu_torch.utils import METRICS

F64 = np.float64
BOUND = 1e-12


def _configs(tmp_path, **kw):
    ref = bof_tpu.FlashConfig(scratch_dir=str(tmp_path / "scratch"),
                              n_io_threads=4, n_compute_threads=2,
                              program_budget=256 << 20,
                              fp64_device="sliced", **kw)
    port = bof_tpu_torch.config_from_reference(dataclasses.asdict(ref),
                                               device="cpu")
    return ref, port


def _write(path, data, order):
    np.ascontiguousarray(data if order == "R" else data.T).tofile(path)


def _read(path, shape, order):
    st = shape if order == "R" else shape[::-1]
    x = np.fromfile(path, F64).reshape(st)
    return x if order == "R" else x.T


def _scaled_err(got, want, opa, opb):
    k = opa.shape[1]
    scale = np.abs(opa).max(axis=1)[:, None] * np.abs(opb).max(axis=0)[None, :]
    return float((np.abs(got - want) / np.maximum(scale * k, 1e-300)).max())


def run_both(tmp_path, order="R", ta="N", tb="N", m=37, n=29, k=41, blk=16,
             alpha=1.5, beta=0.0, seed=0, orders=None, scale_rows=None,
             scale_cols=None, port_fn="gemm", **cfg_kw):
    """bof_tpu's gemm64 and the port's `port_fn` on the same A/B/C files;
    returns the scaled errors (ref vs golden, port vs golden, port vs
    ref)."""
    rng = np.random.default_rng(seed)
    a_shape = (k, m) if ta == "T" else (m, k)
    b_shape = (n, k) if tb == "T" else (k, n)
    a = rng.standard_normal(a_shape)
    b = rng.standard_normal(b_shape)
    c0 = rng.standard_normal((m, n))
    if scale_rows is not None:  # per-row-of-op(A) dynamic range
        a = a * (scale_rows[:, None] if ta == "N" else scale_rows[None, :])
    if scale_cols is not None:  # per-column-of-op(B) dynamic range
        b = b * (scale_cols[None, :] if tb == "N" else scale_cols[:, None])
    oa, ob, oc = orders or (order,) * 3
    d = str(tmp_path)
    paths = {x: os.path.join(d, f"{x}.bin") for x in ("A", "B")}
    _write(paths["A"], a, oa)
    _write(paths["B"], b, ob)
    ref_cfg, port_cfg = _configs(tmp_path, **cfg_kw)
    kw = dict(alpha=alpha, beta=beta, transa=ta, transb=tb, blk=blk)
    out = {}
    for name, pkg, cfg, fn in (
            ("ref", bof_tpu, ref_cfg, ref_gemm64),
            ("port", bof_tpu_torch, port_cfg,
             getattr(bof_tpu_torch, port_fn))):
        c_path = os.path.join(d, f"C_{name}.bin")
        _write(c_path, c0, oc)
        ctx = pkg.FlashContext(cfg)
        try:
            A = pkg.map_array(paths["A"], a_shape, F64, oa, ctx=ctx)
            B = pkg.map_array(paths["B"], b_shape, F64, ob, ctx=ctx)
            C = pkg.map_array(c_path, (m, n), F64, oc, ctx=ctx)
            fn(A, B, C, ctx=ctx, **kw)
        finally:
            ctx.destroy()
        out[name] = _read(c_path, (m, n), oc)
    opa = a.T if ta == "T" else a
    opb = b.T if tb == "T" else b
    golden = alpha * (opa @ opb) + beta * c0
    return (_scaled_err(out["ref"], golden, opa, opb),
            _scaled_err(out["port"], golden, opa, opb),
            _scaled_err(out["port"], out["ref"], opa, opb))


def _check(errs):
    ref_err, port_err, cross = errs
    assert ref_err < BOUND, f"bof_tpu scaled err {ref_err:.3e}"
    assert port_err < BOUND, f"port scaled err {port_err:.3e}"
    assert cross < 2 * BOUND, f"port vs bof_tpu scaled err {cross:.3e}"


@pytest.mark.parametrize("order,ta,tb",
                         list(itertools.product("RC", "NT", "NT")))
def test_all_eight_configs_match_reference(tmp_path, order, ta, tb):
    _check(run_both(tmp_path, order, ta, tb))


@pytest.mark.parametrize("fn", ["gemm", "gemm64"])
@pytest.mark.parametrize("order,ta,tb,alpha,beta", [
    ("R", "N", "N", -2.5, 0.75), ("C", "T", "T", 1.25, -0.5)])
def test_alpha_beta(tmp_path, fn, order, ta, tb, alpha, beta):
    _check(run_both(tmp_path, order, ta, tb, alpha=alpha, beta=beta,
                    port_fn=fn))


def test_mixed_layouts(tmp_path):
    _check(run_both(tmp_path, "R", "N", "T", beta=0.5,
                    orders=("R", "C", "C")))


def test_file_backed_multiblock(tmp_path):
    _check(run_both(tmp_path, "R", "N", "N", beta=0.3, m=70, n=50, k=90,
                    blk=32))


def test_extreme_dynamic_range(tmp_path):
    """Rows and columns spanning hundreds of orders of magnitude: native
    float64 keeps relative accuracy as bof_tpu's per-row/column slicing
    scales do."""
    rng = np.random.default_rng(1)
    _check(run_both(tmp_path, "R", "N", "N",
                    scale_rows=10.0 ** rng.uniform(-120, 120, size=37),
                    scale_cols=10.0 ** rng.uniform(-80, 80, size=29)))


def test_group_schedule_small_device_budget(tmp_path):
    """A device budget too small for one row of tiles forces the
    multi-group sweep (jg -> i -> l -> j) and LRU eviction: the same
    answer, and tiles cross the link more often than there are tiles."""
    METRICS.reset()
    _check(run_both(tmp_path, "R", "N", "T", beta=0.25, m=70, n=60, k=50,
                    blk=16, hbm_budget=2 * 8 * 8 * 16 * 16))
    n_tiles = 5 * 4 + 4 * 4  # A's (i, l) and B's (j, l) tiles
    assert METRICS.get("hbm.miss") > n_tiles


def test_tiled_operands_with_tail(tmp_path):
    """Tile-major float64 operands whose dims are not tile multiples (the
    storage layer hands back full zero-padded tiles) and a beta read of
    the padded C tile, against bof_tpu on the same tiled files."""
    rng = np.random.default_rng(4)
    m, n, k, ts = 20, 13, 22, 16
    a, b, c0 = (rng.standard_normal(s) for s in ((m, k), (k, n), (m, n)))
    ref_cfg, port_cfg = _configs(tmp_path)
    out = {}
    for name, pkg, cfg, fn in (("ref", bof_tpu, ref_cfg, ref_gemm64),
                               ("port", bof_tpu_torch, port_cfg,
                                bof_tpu_torch.gemm)):
        ctx = pkg.FlashContext(cfg)
        try:
            arrs = []
            for nm, shape, data in (("a", (m, k), a), ("b", (k, n), b),
                                    ("c", (m, n), c0)):
                arr = pkg.map_tiled_array(str(tmp_path / f"{nm}_{name}.t"),
                                          shape, F64, tile=ts, create=True,
                                          ctx=ctx)
                arr.write_block(0, data)
                arrs.append(arr)
            fn(*arrs, beta=0.5, blk=ts, ctx=ctx)
            out[name] = arrs[2].read_block(0, m, 0, n)
        finally:
            ctx.destroy()
    golden = a @ b + 0.5 * c0
    for got in out.values():
        assert _scaled_err(got, golden, a, b) < BOUND
    assert _scaled_err(out["port"], out["ref"], a, b) < 2 * BOUND


def test_aliased_operand(tmp_path):
    """A and B backed by the SAME store (C = A @ A) with per-row scales
    10^+-40: one tile serves both roles."""
    rng = np.random.default_rng(2)
    n = 16
    a = rng.standard_normal((n, n)) * (10.0 ** rng.uniform(
        -40, 40, size=n))[:, None]
    ref_cfg, port_cfg = _configs(tmp_path)
    out = {}
    for name, pkg, cfg, fn in (("ref", bof_tpu, ref_cfg, ref_gemm64),
                               ("port", bof_tpu_torch, port_cfg,
                                bof_tpu_torch.gemm)):
        ctx = pkg.FlashContext(cfg)
        try:
            A = pkg.mem_array((n, n), F64, "R", data=a, ctx=ctx)
            C = pkg.mem_array((n, n), F64, "R", ctx=ctx)
            fn(A, A, C, blk=n, ctx=ctx)
            out[name] = C.read_all()
        finally:
            ctx.destroy()
    for got in out.values():
        assert _scaled_err(got, a @ a, a, a) < BOUND


def test_exceeds_fp32_accuracy(tmp_path):
    """Hilbert-like sums whose fp32 result is wrong in the 6th digit come
    out float64-accurate."""
    k = 512
    a = (1.0 / (1.0 + np.arange(k)))[None, :] * np.ones((8, 1))
    b = (1.0 / (1.0 + np.arange(k)))[:, None] * np.ones((1, 8))
    _, cfg = _configs(tmp_path)
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        A = bof_tpu_torch.mem_array((8, k), F64, "R", data=a, ctx=ctx)
        B = bof_tpu_torch.mem_array((k, 8), F64, "R", data=b, ctx=ctx)
        C = bof_tpu_torch.mem_array((8, 8), F64, "R", ctx=ctx)
        bof_tpu_torch.gemm(A, B, C, blk=64, ctx=ctx)
        got = C.read_all()
    finally:
        ctx.destroy()
    np.testing.assert_allclose(got, a @ b, rtol=1e-13)
    f32 = a.astype(np.float32) @ b.astype(np.float32)
    assert np.abs(f32 - a @ b).max() > np.abs(got - a @ b).max()


def test_zero_and_constant_blocks(tmp_path):
    _, cfg = _configs(tmp_path)
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        A = bof_tpu_torch.mem_array((20, 20), F64, "R",
                                    data=np.zeros((20, 20)), ctx=ctx)
        B = bof_tpu_torch.mem_array((20, 20), F64, "R",
                                    data=np.full((20, 20), 3.0), ctx=ctx)
        C = bof_tpu_torch.mem_array((20, 20), F64, "R",
                                    data=np.ones((20, 20)), ctx=ctx)
        bof_tpu_torch.gemm(A, B, C, alpha=2.0, beta=5.0, blk=8, ctx=ctx)
        np.testing.assert_array_equal(C.read_all(), np.full((20, 20), 5.0))
    finally:
        ctx.destroy()


def test_scales_past_the_slicing_window_are_native(tmp_path):
    """Where bof_tpu's slicing cannot see a term (2^600 * 2^-600 pairs
    beside a per-row scale of 2^600: its answer is 0), native float64
    computes it: the port equals numpy exactly, and saturates to a signed
    inf where the true product overflows, as bof_tpu does."""
    k = 8
    a = np.full((4, k), 2.0 ** -600)
    a[:, 0] = 2.0 ** 600
    b = np.full((k, 4), 2.0 ** -600)
    b[1, :] = 2.0 ** 600
    a2 = np.ones((4, k))
    a2[:, 0] = 2.0 ** 600
    b2 = np.ones((k, 4))
    b2[0, :] = 2.0 ** 600
    b2[0, 2] = -(2.0 ** 600)
    _, cfg = _configs(tmp_path)
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        got = []
        for x, y in ((a, b), (a2, b2)):
            A = bof_tpu_torch.mem_array((4, k), F64, "R", data=x, ctx=ctx)
            B = bof_tpu_torch.mem_array((k, 4), F64, "R", data=y, ctx=ctx)
            C = bof_tpu_torch.mem_array((4, 4), F64, "R", ctx=ctx)
            bof_tpu_torch.gemm64(A, B, C, blk=8, ctx=ctx)
            got.append(C.read_all())
    finally:
        ctx.destroy()
    np.testing.assert_array_equal(got[0], np.full((4, 4), 2.0))
    with np.errstate(over="ignore"):
        assert np.array_equal(got[0], a @ b)
    assert np.isposinf(got[1][:, [0, 1, 3]]).all()
    assert np.isneginf(got[1][:, 2]).all()


@pytest.mark.parametrize("fn", ["gemm", "gemm64"])
def test_debug_checks_rejects_nonfinite(tmp_path, fn):
    """With debug_checks a non-finite operand is a ValueError before
    anything is computed (C untouched), and no tile stays pinned: after
    the fix the same arrays compute cleanly."""
    rng = np.random.default_rng(3)
    _, cfg = _configs(tmp_path, debug_checks=True)
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        a = rng.standard_normal((20, 20))
        a[3, 7] = np.inf
        b = rng.standard_normal((20, 20))
        A = bof_tpu_torch.mem_array((20, 20), F64, "R", data=a, ctx=ctx)
        B = bof_tpu_torch.mem_array((20, 20), F64, "R", data=b, ctx=ctx)
        C = bof_tpu_torch.mem_array((20, 20), F64, "R", ctx=ctx)
        gemm_fn = getattr(bof_tpu_torch, fn)
        with pytest.raises(ValueError, match="non-finite"):
            gemm_fn(A, B, C, blk=16, ctx=ctx)
        assert not C.read_all().any()
        B.write_all(np.where(np.arange(20)[:, None] == 5, np.nan, b))
        a[3, 7] = 1.0
        A.write_all(a)
        with pytest.raises(ValueError, match="non-finite"):
            gemm_fn(A, B, C, blk=16, ctx=ctx)
        B.write_all(b)
        gemm_fn(A, B, C, blk=16, ctx=ctx)
        np.testing.assert_allclose(C.read_all(), a @ b, rtol=1e-12)
    finally:
        ctx.destroy()


@pytest.mark.parametrize("field,value", [("transfer_dtype", "bfloat16"),
                                         ("transfer_dtype", "int8"),
                                         ("c_transfer_dtype", "bfloat16")])
@pytest.mark.parametrize("fn", ["gemm", "gemm64"])
def test_transfer_mode_on_float64_raises(tmp_path, field, value, fn):
    """bof_tpu's error for a transfer mode on float64 operands
    (bof_tpu/ops/gemm.py:214-219) is a ValueError, raised before any I/O."""
    _, cfg = _configs(tmp_path, **{field: value})
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        a = bof_tpu_torch.mem_array((8, 8), F64, ctx=ctx, data=np.eye(8))
        c = bof_tpu_torch.mem_array((8, 8), F64, ctx=ctx)
        with pytest.raises(ValueError, match="transfer mode"):
            getattr(bof_tpu_torch, fn)(a, a, c, blk=4, ctx=ctx)
        assert not c.read_all().any()
    finally:
        ctx.destroy()


def test_resume_journal_on_float64(tmp_path):
    """The journal header names float64 as bof_tpu's does; a run resumed
    with two superblocks already durable gives the uninterrupted bytes."""
    n, blk = 48, 16
    rng = np.random.default_rng(11)
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    header = port_journal_header(n, n, n, 1.0, 0.0, "N", "N", blk,
                                 np.dtype(F64), "float32")
    assert header == ref_journal_header(n, n, n, 1.0, 0.0, "N", "N", blk,
                                        np.dtype(F64), "float32")
    assert '"dtype": "float64"' in header
    _, cfg = _configs(tmp_path)
    journal = str(tmp_path / "journal.txt")

    def run(c_init):
        ctx = bof_tpu_torch.FlashContext(cfg)
        try:
            A = bof_tpu_torch.mem_array((n, n), F64, data=a, ctx=ctx)
            B = bof_tpu_torch.mem_array((n, n), F64, data=b, ctx=ctx)
            C = bof_tpu_torch.map_array(str(tmp_path / "C.bin"), (n, n), F64,
                                        create=True, ctx=ctx)
            C.write_all(c_init)
            bof_tpu_torch.gemm(A, B, C, blk=blk, ctx=ctx,
                               resume_journal=journal)
            return C.read_all()
        finally:
            ctx.destroy()
    want = run(np.zeros((n, n)))
    assert not os.path.exists(journal)
    c = np.full((n, n), np.nan)
    c[:blk, :2 * blk] = want[:blk, :2 * blk]
    with open(journal, "w") as f:
        f.write(header + "\n0 0\n0 1\n")
    METRICS.reset()
    got = run(c)
    assert not os.path.exists(journal)
    assert METRICS.get("gemm.d2h_bytes") == (n * n - 2 * blk * blk) * 8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(want, a @ b, rtol=1e-12, atol=1e-12)


def test_gemm64_signature_is_the_reference_one():
    assert (str(inspect.signature(bof_tpu_torch.gemm64))
            == str(inspect.signature(bof_tpu.gemm64)))
    assert bof_tpu_torch.gemm64.__name__ == "gemm64"


def test_gemm64_knobs_keep_the_reference_contract(tmp_path):
    """`slices` is range-checked as bof_tpu checks it and changes nothing
    else, `k_flush` is accepted, and `mesh=` (a world of one rank) gives
    the same bits as no mesh."""
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((24, 128)), rng.standard_normal((128, 20))
    _, cfg = _configs(tmp_path)
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        A = bof_tpu_torch.mem_array(a.shape, F64, data=a, ctx=ctx)
        B = bof_tpu_torch.mem_array(b.shape, F64, data=b, ctx=ctx)
        outs = []
        for kw in ({}, {"slices": 2, "k_flush": 16}, {"slices": 12,
                                                       "k_flush": 10 ** 9}):
            C = bof_tpu_torch.mem_array((24, 20), F64, ctx=ctx)
            bof_tpu_torch.gemm64(A, B, C, blk=16, ctx=ctx, **kw)
            outs.append(C.read_all())
        for s in (1, 13):
            with pytest.raises(ValueError, match=r"\[2, 12\]"):
                bof_tpu_torch.gemm64(A, B, C, blk=16, ctx=ctx, slices=s)
        from torch_dist_pool import one_rank_world
        with one_rank_world() as mesh:
            C = bof_tpu_torch.mem_array((24, 20), F64, ctx=ctx)
            bof_tpu_torch.gemm64(A, B, C, blk=16, ctx=ctx, mesh=mesh)
            outs.append(C.read_all())
        A32 = bof_tpu_torch.mem_array((8, 8), np.float32, ctx=ctx)
        with pytest.raises(ValueError, match="float64"):
            bof_tpu_torch.gemm64(A32, A32, A32, ctx=ctx)
    finally:
        ctx.destroy()
    for got in outs[1:]:
        np.testing.assert_array_equal(got, outs[0])
    assert _scaled_err(outs[0], a @ b, a, b) < BOUND
