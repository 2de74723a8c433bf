"""The port's sparse slice (csrmm, csrgemv, csrcsc, their drivers and host
helpers) against bof_tpu's, on the same files.

Each case writes a CSR triplet (.off/.col/.csr, the reference's format)
and dense operands once from a seeded generator, runs `bof_tpu.sparse`
and `bof_tpu_torch.sparse` (device "cpu": the kernels' plain versions)
over them under one configuration carried across by
`config_from_reference`, and compares both outputs with each other and
with the scipy golden at tests/test_sparse.py's tolerance (rtol 1e-4,
atol 1e-4).  Tiny max_nnzs / csrmm_cblk_size make every case multi-block.
"""
import dataclasses
import os

import numpy as np
import pytest
import scipy.sparse as sps

import bof_tpu
import bof_tpu.sparse
import bof_tpu_torch
import bof_tpu_torch.sparse
from bof_tpu_torch.utils import METRICS

F32 = np.float32
TOL = dict(rtol=1e-4, atol=1e-4)


def rand_csr(m, k, density, seed=42, dtype=F32):
    return sps.random(m, k, density=density, format="csr", dtype=dtype,
                      random_state=np.random.RandomState(seed))


def _configs(tmp_path, max_nnzs=2048, cblk=32, **kw):
    ref = bof_tpu.FlashConfig(scratch_dir=str(tmp_path / "scratch"),
                              n_io_threads=4, n_compute_threads=2,
                              program_budget=256 << 20, max_nnzs=max_nnzs,
                              csrmm_cblk_size=cblk, **kw)
    port = bof_tpu_torch.config_from_reference(dataclasses.asdict(ref),
                                               device="cpu")
    return {bof_tpu: ref, bof_tpu_torch: port}


def write_csr(prefix, a_sp, val_dtype=F32):
    a_sp = a_sp.tocsr()
    a_sp.sort_indices()
    a_sp.indptr.astype(np.int64).tofile(prefix + ".off")
    a_sp.indices.astype(np.int64).tofile(prefix + ".col")
    a_sp.data.astype(val_dtype).tofile(prefix + ".csr")


def _write(path, data, order):
    np.ascontiguousarray(data if order == "R" else data.T).tofile(path)


def _read(path, shape, order, dtype=F32):
    st = shape if order == "R" else shape[::-1]
    x = np.fromfile(path, dtype).reshape(st)
    return x if order == "R" else x.T


def csrmm_both(tmp_path, a_sp, n, alpha=1.5, beta=0.5, transa="N",
               order_b="R", order_c="R", dtype=F32, seed=0, **cfg_kw):
    """csrmm through both packages on the same files; returns
    (ref C, port C, golden C)."""
    rng = np.random.default_rng(seed)
    m, k = a_sp.shape
    b_rows, c_rows = (m, k) if transa == "T" else (k, m)
    b = rng.standard_normal((b_rows, n)).astype(dtype)
    c0 = rng.standard_normal((c_rows, n)).astype(dtype)
    d = str(tmp_path)
    prefix = os.path.join(d, "A")
    write_csr(prefix, a_sp, dtype)
    b_path = os.path.join(d, "B.bin")
    _write(b_path, b, order_b)
    out = {}
    for pkg, cfg in _configs(tmp_path, **cfg_kw).items():
        c_path = os.path.join(d, f"C_{pkg.__name__}.bin")
        _write(c_path, c0, order_c)
        ctx = pkg.FlashContext(cfg)
        try:
            A = pkg.sparse.CsrFlashMatrix.map_files(prefix, (m, k),
                                                    val_dtype=dtype, ctx=ctx)
            B = pkg.map_array(b_path, (b_rows, n), dtype, order_b, ctx=ctx)
            C = pkg.map_array(c_path, (c_rows, n), dtype, order_c, ctx=ctx)
            pkg.sparse.csrmm(A, B, C, alpha=alpha, beta=beta, transa=transa,
                             ctx=ctx)
        finally:
            ctx.destroy()
        out[pkg] = _read(c_path, (c_rows, n), order_c, dtype)
    opa = a_sp.T if transa == "T" else a_sp
    golden = alpha * (opa.astype(np.float64) @ b.astype(np.float64)) \
        + beta * c0.astype(np.float64)
    return out[bof_tpu], out[bof_tpu_torch], golden


def _check(ref, port, golden, tol=TOL):
    np.testing.assert_allclose(port, ref, **tol)
    np.testing.assert_allclose(port, golden, **tol)


# ------------------------------------------------------------------ csrmm

@pytest.mark.parametrize("density", [0.002, 0.05])
@pytest.mark.parametrize("order_b", ["R", "C"])
def test_csrmm_n(tmp_path, density, order_b):
    _check(*csrmm_both(tmp_path, rand_csr(300, 200, density), 70,
                       order_b=order_b))


def test_csrmm_c_order_output(tmp_path):
    _check(*csrmm_both(tmp_path, rand_csr(150, 120, 0.03), 40, alpha=1.0,
                       beta=0.0, order_c="C"))


@pytest.mark.parametrize("path", ["streaming", "csrcsc"])
def test_csrmm_transposed(tmp_path, path):
    """'T' both ways: the one-pass host streaming accumulate, and csrcsc
    into scratch + recursion as 'N' on the device path."""
    mode = "host" if path == "streaming" else "device"
    _check(*csrmm_both(tmp_path, rand_csr(180, 90, 0.04), 30, alpha=0.5,
                       beta=2.0, transa="T", sparse_compute=mode))


def test_csrmm_host_compute(tmp_path):
    _check(*csrmm_both(tmp_path, rand_csr(200, 150, 0.03), 48, alpha=2.0,
                       beta=0.25, sparse_compute="host"))


@pytest.mark.parametrize("mode", ["device", "host"])
def test_csrmm_k_split(tmp_path, mode):
    """A tiny device budget splits K into 4096-wide ranges accumulated
    into C through the range barrier."""
    cblk = 16 if mode == "device" else 8
    _check(*csrmm_both(tmp_path, rand_csr(150, 10_000, 0.003), 24,
                       alpha=1.25, beta=0.5, max_nnzs=1024, cblk=cblk,
                       hbm_budget=3 * 4096 * cblk * 4, sparse_compute=mode))


@pytest.mark.parametrize("sort_rows", [True, False])
def test_csrmm_power_law_rows_banding(tmp_path, sort_rows):
    """Mega-rows beside near-empty rows, with and without count-sorted
    ELL banding; a small budget gives the mega-rows bands of their own."""
    rng = np.random.default_rng(21)
    a = rand_csr(400, 150, 0.03, seed=21).tolil()
    for r in (17, 150, 388):
        a[r, :] = rng.standard_normal(150)
    _check(*csrmm_both(tmp_path, a.tocsr(), 48, max_nnzs=1 << 14,
                       cblk=48, hbm_budget=6 * 48 * 4 * 1024,
                       sparse_compute="device", ell_sort_rows=sort_rows))


@pytest.mark.parametrize("narrow", [True, False])
def test_csrmm_ell_idx_narrow(tmp_path, narrow):
    """uint16 ELL indices (panel height <= 65536) and int32 ones."""
    ref, port, golden = csrmm_both(tmp_path, rand_csr(257, 300, 0.05, 7),
                                   40, max_nnzs=1 << 14,
                                   sparse_compute="device",
                                   ell_idx_narrow=narrow)
    _check(ref, port, golden)


def test_csrmm_float64_exact_without_device_path(tmp_path):
    """fp64 values never reach the fp32 kernels: the scipy host path is
    exact even with sparse_compute='device' (as bof_tpu without x64)."""
    a = rand_csr(200, 150, 0.05, 7, dtype=np.float64)
    a.data *= 10.0 ** np.random.default_rng(3).uniform(-9, 9, a.nnz)
    ref, port, golden = csrmm_both(tmp_path, a, 40, dtype=np.float64,
                                   sparse_compute="device")
    np.testing.assert_allclose(port, golden, rtol=1e-13)
    np.testing.assert_allclose(port, ref, rtol=1e-13)


def test_csrmm_debug_checks(tmp_path):
    """debug_checks validates every streamed block: a sound matrix runs,
    a column index past k raises in both packages."""
    _check(*csrmm_both(tmp_path, rand_csr(120, 80, 0.05), 16,
                       debug_checks=True))
    prefix = os.path.join(str(tmp_path), "A")
    ja = np.fromfile(prefix + ".col", np.int64)
    ja[len(ja) // 2] = 80 + 5
    ja.tofile(prefix + ".col")
    for pkg, cfg in _configs(tmp_path, debug_checks=True).items():
        ctx = pkg.FlashContext(cfg)
        try:
            A = pkg.sparse.CsrFlashMatrix.map_files(prefix, (120, 80),
                                                    ctx=ctx)
            B = pkg.mem_array((80, 16), F32, ctx=ctx)
            C = pkg.mem_array((120, 16), F32, ctx=ctx)
            with pytest.raises(ValueError, match="out of range"):
                pkg.sparse.csrmm(A, B, C, ctx=ctx)
        finally:
            ctx.destroy()


def test_csrmm_telemetry_sync_records_stages(tmp_path):
    METRICS.reset()
    _check(*csrmm_both(tmp_path, rand_csr(300, 120, 0.05, 11), 64,
                       sparse_compute="device", telemetry_sync=True))
    snap = METRICS.snapshot()
    for key in ("csrmm.h2d_s", "csrmm.d2h_s", "csrmm.accum_wait_s",
                "csrmm.prep_s", "csrmm.disk_wait_s"):
        assert key in snap, key
    assert METRICS.samples("csrmm.h2d_tile_gbps")
    assert METRICS.samples("csrmm.d2h_tile_gbps")


def test_csrmm_in_mem_twin_matches_reference():
    a = rand_csr(60, 40, 0.1)
    rng = np.random.default_rng(4)
    b = rng.standard_normal((60, 7)).astype(F32)
    c = rng.standard_normal((40, 7)).astype(F32)
    want = bof_tpu.sparse.csrmm_in_mem(a, b, c, 0.5, 2.0, "T")
    got = bof_tpu_torch.sparse.csrmm_in_mem(a, b, c, 0.5, 2.0, "T")
    np.testing.assert_array_equal(got, want)


def test_sparse_compute_auto_dispatch(monkeypatch):
    """'auto' places block products by the measured link: a real link
    picks the device; a thin link keeps small problems on the host."""
    import importlib
    csrmm_mod = importlib.import_module("bof_tpu_torch.sparse.csrmm")
    cfg = bof_tpu_torch.FlashConfig(sparse_compute="auto", device="cpu")
    monkeypatch.setattr("bof_tpu_torch.ops.device.link_gbps_estimate",
                        lambda device: 20.0)
    assert csrmm_mod._resolve_sparse_compute(
        cfg, 1 << 20, 1 << 16, 1024, 1 << 27) == "device"
    monkeypatch.setattr("bof_tpu_torch.ops.device.link_gbps_estimate",
                        lambda device: 0.04)
    assert csrmm_mod._resolve_sparse_compute(
        cfg, 1 << 16, 1 << 14, 512, 1 << 23) == "host"
    for mode in ("device", "host"):
        assert csrmm_mod._resolve_sparse_compute(
            cfg.replace(sparse_compute=mode), 8, 8, 8, 8) == mode


def test_device_placement_helpers():
    import torch
    from bof_tpu_torch.ops import device as port_dev
    assert port_dev.dtype_native_on_device(np.float32)
    assert port_dev.dtype_native_on_device(np.uint16)
    assert not port_dev.dtype_native_on_device(np.float64)
    assert not port_dev.dtype_native_on_device(np.int64)
    assert port_dev.link_gbps_estimate(torch.device("cpu")) == np.inf


# bof_tpu's bands against float64 (tests/test_gemm.py): bf16 inputs 2e-2
# of max|C|, int8 inputs 5e-2, a bf16 C download 1e-2
BANDS = {("bfloat16", "float32"): 2e-2, ("int8", "float32"): 5e-2,
         ("float32", "bfloat16"): 1e-2, ("int8", "bfloat16"): 5e-2}


def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, e - 8)


def check_mode(ref, port, golden, xfer, c_xfer, alpha=1.0):
    """The port against bof_tpu in a transfer mode: 2e-4 of max|C| (both
    round the same inputs the same way; the sums' order differs), or, with
    a bf16 C download (beta 0 here), one bf16 ulp of the band product an
    element, times alpha (bof_tpu rounds the product, then scales it); and
    both inside bof_tpu's band against float64 but off it: the mode really
    rounded."""
    if c_xfer == "bfloat16":
        prod = np.abs(golden) / abs(alpha) * (1 + 2.0 ** -7)
        assert (np.abs(port.astype(np.float64) - ref)
                <= abs(alpha) * bf16_ulp(prod)).all()
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
    """Each transfer mode that was refused before it was ported now runs
    through csrmm (and, for the value modes, csrgemv 'N') and matches
    bof_tpu on the same files.  The name dates from the refusal and is
    kept so the cases' history reads on."""
    modes = {"transfer_dtype": "float32", "c_transfer_dtype": "float32",
             field: value}
    a_sp = rand_csr(200, 150, 0.05)
    beta = 0.0 if modes["c_transfer_dtype"] == "bfloat16" else 0.5
    for sub in ("mm", "mv"):
        (tmp_path / sub).mkdir()
    ref, port, golden = csrmm_both(tmp_path / "mm", a_sp, 40, alpha=0.75,
                                   beta=beta, sparse_compute="device",
                                   **modes)
    check_mode(ref, port, golden, modes["transfer_dtype"],
               modes["c_transfer_dtype"], alpha=0.75)
    if field == "transfer_dtype":
        ref, port, golden = csrgemv_both(tmp_path / "mv", a_sp, "N",
                                         max_nnzs=512, **modes)
        check_mode(ref, port, golden, value, "float32")


@pytest.mark.parametrize("xfer,c_xfer", list(BANDS))
@pytest.mark.parametrize("transa", ["N", "T"])
def test_csrmm_transfer_modes(tmp_path, transa, xfer, c_xfer):
    """csrmm 'N' and 'T' (csrcsc, then 'N' on the device path) in every
    mode, and int8 values with a bf16 C download, over several row blocks,
    ELL bands and column panels (a ragged last one)."""
    beta = 0.0 if c_xfer == "bfloat16" else 2.0
    ref, port, golden = csrmm_both(
        tmp_path, rand_csr(300, 200, 0.05), 70, alpha=0.5, beta=beta,
        transa=transa, sparse_compute="device", transfer_dtype=xfer,
        c_transfer_dtype=c_xfer)
    check_mode(ref, port, golden, xfer, c_xfer, alpha=0.5)


@pytest.mark.parametrize("xfer", ["bfloat16", "int8"])
def test_csrgemv_transfer_modes(tmp_path, xfer):
    ref, port, golden = csrgemv_both(tmp_path, rand_csr(400, 250, 0.02), "N",
                                     max_nnzs=512, transfer_dtype=xfer)
    check_mode(ref, port, golden, xfer, "float32")


def test_sparse_transfer_modes_cross_the_link_in_fewer_bytes(tmp_path):
    """The ELL uploads shrink with the value type (int8 values plus a
    scale a row below bf16 below fp32, the indices unchanged), csrmm's
    downloads halve under the bf16 C download, and the kernels launch as
    often in every mode."""
    a_sp = rand_csr(300, 200, 0.05)
    seen = {}
    for xfer, c_xfer in (("float32", "float32"),) + tuple(BANDS):
        d = tmp_path / f"{xfer}_{c_xfer}"
        d.mkdir()
        METRICS.reset()
        csrmm_both(d, a_sp, 70, beta=0.0, sparse_compute="device",
                   transfer_dtype=xfer, c_transfer_dtype=c_xfer)
        csrgemv_both(d, a_sp, "N", max_nnzs=512, transfer_dtype=xfer,
                     c_transfer_dtype=c_xfer)
        seen[(xfer, c_xfer)] = {key: METRICS.get(key) for key in (
            "csrmm.h2d_bytes", "csrmm.d2h_bytes", "csrgemv.h2d_bytes")}
    base = seen[("float32", "float32")]
    assert base["csrmm.d2h_bytes"] == 300 * 96 * 4  # 3 panels of cb 32
    for (xfer, c_xfer), got in seen.items():
        assert got["csrmm.d2h_bytes"] == base["csrmm.d2h_bytes"] // (
            2 if c_xfer == "bfloat16" else 1)
    for key in ("csrmm.h2d_bytes", "csrgemv.h2d_bytes"):
        f32, bf16, i8 = (seen[(x, "float32")][key]
                         for x in ("float32", "bfloat16", "int8"))
        assert i8 < bf16 < f32, (key, f32, bf16, i8)
        assert seen[("int8", "bfloat16")][key] == i8


# ---------------------------------------------------------------- csrgemv

def csrgemv_both(tmp_path, a_sp, trans, dtype=F32, **cfg_kw):
    m, k = a_sp.shape
    x = np.random.default_rng(1).standard_normal(
        m if trans == "T" else k).astype(dtype)
    out = {}
    for pkg, cfg in _configs(tmp_path, **cfg_kw).items():
        ctx = pkg.FlashContext(cfg)
        try:
            A = pkg.sparse.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx,
                                                     val_dtype=dtype)
            out[pkg] = pkg.sparse.csrgemv(A, x, trans=trans, ctx=ctx)
        finally:
            ctx.destroy()
    golden = (a_sp.T if trans == "T" else a_sp).astype(np.float64) \
        @ x.astype(np.float64)
    return out[bof_tpu], out[bof_tpu_torch], golden


@pytest.mark.parametrize("trans", ["N", "T"])
def test_csrgemv(tmp_path, trans):
    _check(*csrgemv_both(tmp_path, rand_csr(400, 250, 0.02), trans,
                         max_nnzs=512))


def test_csrgemv_empty_rows(tmp_path):
    a = rand_csr(100, 80, 0.01).tolil()
    a[40:60, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    ref, port, golden = csrgemv_both(tmp_path, a, "N", max_nnzs=256)
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port, golden, rtol=1e-4, atol=1e-5)
    assert not port[40:60].any()


@pytest.mark.parametrize("trans", ["N", "T"])
def test_csrgemv_float64_exact(tmp_path, trans):
    a = rand_csr(300, 120, 0.08, 8, dtype=np.float64)
    ref, port, golden = csrgemv_both(tmp_path, a, trans, dtype=np.float64)
    assert port.dtype == np.float64
    np.testing.assert_allclose(port, golden, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port, ref, rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------- csrcsc

def csrcsc_both(tmp_path, build, max_nnzs):
    """A^T through both packages' csrcsc_scratch; returns (ia, ja, vals)
    per package."""
    out = {}
    for pkg, cfg in _configs(tmp_path, max_nnzs=max_nnzs).items():
        ctx = pkg.FlashContext(cfg)
        try:
            At = pkg.sparse.csrcsc_scratch(build(pkg, ctx), ctx=ctx)
            out[pkg] = (At.read_ia(), At.ja.read_all(), At.vals.read_all())
            for arr in (At.ia, At.ja, At.vals):
                pkg.flash_free(arr)
        finally:
            ctx.destroy()
    return out[bof_tpu], out[bof_tpu_torch]


@pytest.mark.parametrize("density", [0.005, 0.08])
def test_csrcsc_roundtrip(tmp_path, density):
    a = rand_csr(230, 170, density)
    ref, port = csrcsc_both(
        tmp_path, lambda pkg, ctx: pkg.sparse.CsrFlashMatrix.from_scipy(
            a, ctx=ctx), 1024)
    want = sps.csr_matrix(a.T)
    want.sort_indices()
    for r, p, w in zip(ref, port, (want.indptr, want.indices, want.data)):
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(p, w)
    ia, ja = port[0], port[1]
    for c in range(len(ia) - 1):  # source rows ascend within each column
        assert np.all(np.diff(ja[ia[c]:ia[c + 1]]) > 0)


def test_csrcsc_keeps_explicit_zeros_and_duplicates(tmp_path):
    ia = np.array([0, 2, 5, 6], np.int64)
    ja = np.array([1, 2, 1, 1, 2, 0], np.int64)
    va = np.array([0.0, 5.0, 1.0, 2.0, 0.0, 7.0], F32)

    def build(pkg, ctx):
        return pkg.sparse.CsrFlashMatrix(
            pkg.mem_array((4,), np.int64, data=ia, ctx=ctx),
            pkg.mem_array((6,), np.int64, data=ja, ctx=ctx),
            pkg.mem_array((6,), F32, data=va, ctx=ctx), (3, 3))
    ref, port = csrcsc_both(tmp_path, build, 4)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(port[0], [0, 1, 4, 6])
    np.testing.assert_array_equal(port[1], [2, 0, 1, 1, 0, 1])
    np.testing.assert_array_equal(port[2], [7.0, 0.0, 1.0, 2.0, 5.0, 0.0])


def test_csrcsc_rejects_row_count_past_index_dtype(tmp_path):
    cfg = _configs(tmp_path)[bof_tpu_torch]
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        A = bof_tpu_torch.CsrFlashMatrix.from_scipy(
            rand_csr(40, 30, 0.1, 5), ctx=ctx, idx_dtype=np.int32)
        A.shape = (2 ** 31 + 8, 30)  # a row count int32 cannot index
        out = bof_tpu_torch.CsrFlashMatrix(
            bof_tpu_torch.mem_array((31,), np.int64, ctx=ctx),
            bof_tpu_torch.mem_array((A.nnz,), np.int32, ctx=ctx),
            bof_tpu_torch.mem_array((A.nnz,), F32, ctx=ctx),
            (30, 2 ** 31 + 8))
        with pytest.raises(ValueError, match="index dtype"):
            bof_tpu_torch.csrcsc(A, out, ctx=ctx)
    finally:
        ctx.destroy()


# ----------------------------------------------------------- host helpers

@pytest.mark.parametrize("idt", [np.int32, np.uint16])
@pytest.mark.parametrize("vdt", [np.float32, np.float64])
def test_native_ell_fill_matches_numpy_chain(idt, vdt):
    """The engine's ELL gather, bound by the port, is bit-identical to
    bof_tpu's numpy chain (which bof_tpu uses when its engine is absent)."""
    from bof_tpu_torch.io.native import ell_fill
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 9, 37).astype(np.int64)
    counts[5] = 0
    starts = np.zeros(37, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    nnz = int(counts.sum())
    ja = rng.integers(0, 60000, nnz).astype(np.int64)
    va = rng.standard_normal(nnz).astype(vdt)
    va[3] = np.nan
    got = ell_fill(starts, counts, ja, va, 64, 16, idt, None)
    assert got is not None
    slots = np.arange(16)[None, :]
    idx = np.minimum(starts[:, None] + slots, nnz - 1)
    mask = slots < counts[:, None]
    want_ja = np.zeros((64, 16), idt)
    want_va = np.zeros((64, 16), vdt)
    want_ja[:37] = np.where(mask, ja[idx], 0).astype(idt)
    want_va[:37] = np.where(mask, va[idx], 0)
    np.testing.assert_array_equal(got[0], want_ja)
    np.testing.assert_array_equal(got[1].view(np.uint8),
                                  want_va.view(np.uint8))


def test_native_ell_fill_leaves_unbound_modes_to_numpy():
    """Indices that are not int64 still go to the numpy chain; the bf16
    value mode (np.uint16 bits, the port's bfloat16) is bound now and
    rounds as ml_dtypes does; a value type the engine lacks is left to
    numpy."""
    import ml_dtypes
    from bof_tpu_torch.io.native import ell_fill
    one = np.ones(1, np.int64)
    assert ell_fill(np.zeros(1, np.int64), one, np.zeros(1, np.int32),
                    np.zeros(1, F32), 8, 8, np.int32, None) is None
    val = np.array([1.00390625], F32)  # a tie: rounds to even, 1.0
    got = ell_fill(np.zeros(1, np.int64), one, one, val, 8, 8, np.int32,
                   np.uint16)
    assert got is not None and got[1].dtype == np.uint16
    assert got[1][0, 0] == val.astype(ml_dtypes.bfloat16).view(np.uint16)[0]
    assert not got[1][1:].any() and not got[1][0, 1:].any()
    assert ell_fill(np.zeros(1, np.int64), one, one, val, 8, 8, np.int32,
                    np.dtype(ml_dtypes.bfloat16)) is None


def test_counting_argsort_matches_stable_argsort():
    from bof_tpu.io.native import counting_argsort_i32 as ref_sort
    from bof_tpu_torch.io.native import counting_argsort_i32
    keys = np.random.default_rng(3).integers(0, 97, 50_000).astype(np.int32)
    got = counting_argsort_i32(keys, 97)
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(got, ref_sort(keys, 97))
    assert counting_argsort_i32(keys, 0) is None  # out of range: fallback


# ---------------------------------------------------------------- drivers

def test_sparse_create_is_byte_identical(tmp_path):
    from bof_tpu.drivers import sparse_create as ref_create
    from bof_tpu_torch.drivers import sparse_create as port_create
    args = ["3000", "500", "7.5", "--seed", "9", "--chunk-rows", "700"]
    ref_create.main([str(tmp_path / "ref")] + args)
    port_create.main([str(tmp_path / "port")] + args)
    for ext in (".off", ".col", ".csr"):
        with open(tmp_path / f"ref{ext}", "rb") as f:
            want = f.read()
        with open(tmp_path / f"port{ext}", "rb") as f:
            assert f.read() == want, ext


def test_sparse_drivers_run_on_cpu(tmp_path, capsys):
    """sparse_create -> csrmm / csrgemv / csrcsc / in_mem_sparse, as a
    user runs them, against scipy."""
    from bof_tpu_torch.drivers import (csrcsc, csrgemv, csrmm,
                                       in_mem_sparse, sparse_create)
    d = str(tmp_path)
    pre = os.path.join(d, "A")
    m, k, n = 500, 300, 24
    sparse_create.main([pre, str(m), str(k), "6", "--seed", "3"])
    a = in_mem_sparse.load_csr(pre, m, k)
    rng = np.random.default_rng(5)
    b = rng.standard_normal((k, n)).astype(F32)
    b.tofile(os.path.join(d, "B.bin"))
    common = ["--device", "cpu", "--scratch", os.path.join(d, "s")]
    secs = csrmm.main([pre, str(m), str(k), os.path.join(d, "B.bin"),
                       str(n), os.path.join(d, "C.bin"), "--create-c",
                       "--alpha", "2"] + common)
    assert secs > 0
    got = np.fromfile(os.path.join(d, "C.bin"), F32).reshape(m, n)
    np.testing.assert_allclose(got, 2.0 * (a @ b), **TOL)

    x = rng.standard_normal(m).astype(F32)
    x.tofile(os.path.join(d, "x.bin"))
    assert csrgemv.main([pre, str(m), str(k), os.path.join(d, "x.bin"),
                         os.path.join(d, "y.bin"), "--trans", "T"]
                        + common) > 0
    np.testing.assert_allclose(np.fromfile(os.path.join(d, "y.bin"), F32),
                               a.T @ x, **TOL)

    csrcsc.main([pre, str(m), str(k), os.path.join(d, "AT")] + common)
    at = in_mem_sparse.load_csr(os.path.join(d, "AT"), k, m)
    assert (at != sps.csr_matrix(a.T)).nnz == 0

    in_mem_sparse.main(["csrmm", pre, str(m), str(k),
                        os.path.join(d, "B.bin"), str(n),
                        os.path.join(d, "C2.bin")])
    np.testing.assert_allclose(
        np.fromfile(os.path.join(d, "C2.bin"), F32).reshape(m, n),
        a @ b, **TOL)
    assert "checksum" in capsys.readouterr().out

    from torch_dist_pool import one_rank_world
    with one_rank_world():
        csrmm.main([pre, str(m), str(k), os.path.join(d, "B.bin"), str(n),
                    os.path.join(d, "C.bin"), "--alpha", "2", "--sharded"]
                   + common)
    got = np.fromfile(os.path.join(d, "C.bin"), F32).reshape(m, n)
    np.testing.assert_allclose(got, 2.0 * (a @ b), **TOL)


# ------------------------------------------------- bands written in place

def _count_downloads(monkeypatch):
    """Count the port's device-to-host copies (ops/device.from_device)."""
    from bof_tpu_torch.ops import device as port_dev
    calls = []
    real = port_dev.from_device

    def counted(t):
        calls.append(tuple(t.shape))
        return real(t)
    monkeypatch.setattr(port_dev, "from_device", counted)
    return calls


@pytest.mark.parametrize("mode", ["device", "host"])
def test_csrmm_bands_write_in_place(tmp_path, monkeypatch, mode):
    """The device path: each band writes its rows of the row block's
    buffer with alpha applied, so the writer assembles nothing on the host
    (no csrmm.assemble_s) and downloads each row block of each column
    panel once, in contiguous row pieces; the host path still applies
    alpha on the host.  The whole C equals bof_tpu's on the same files."""
    from bof_tpu_torch.sparse.csr import fill_row_blocks
    a = rand_csr(400, 150, 0.04, seed=23).tolil()
    a[10:30, :] = 0  # empty rows: alpha * 0 from K2
    a = a.tocsr()
    a.eliminate_zeros()
    import importlib
    csrmm_mod = importlib.import_module("bof_tpu_torch.sparse.csrmm")
    monkeypatch.setattr(csrmm_mod, "PIECE_BYTES", 40 * 32 * 4)  # 40 rows
    calls = _count_downloads(monkeypatch)
    METRICS.reset()
    _check(*csrmm_both(tmp_path, a, 50, alpha=0.75, beta=0.5,
                       max_nnzs=1024, cblk=32, sparse_compute=mode))
    snap = METRICS.snapshot()
    blocks = fill_row_blocks(a.indptr.astype(np.int64), 1024)
    if mode == "device":
        assert "csrmm.assemble_s" not in snap
        # each row block of each of the two 32-wide panels (n 50) comes
        # down once, in pieces of at most 40 contiguous rows
        pieces = [(min(40, e - r - p0), 32) for r, e in blocks
                  for p0 in range(0, e - r, 40)]
        assert sorted(calls) == sorted(pieces * 2)
        assert snap["csrmm.d2h_bytes"] == 400 * 32 * 2 * 4
    else:
        assert snap["csrmm.assemble_s"] > 0
        assert not calls


def test_csrgemv_bands_write_in_place(tmp_path, monkeypatch):
    """csrgemv 'N': each band's SpMV writes its rows of the block's y in
    place; y comes down once per row block and equals bof_tpu's."""
    from bof_tpu_torch.sparse.csr import fill_row_blocks
    a = rand_csr(500, 300, 0.03, seed=24).tolil()
    a[100:140, :] = 0
    a[7, :] = 1.0  # a long row beside short ones: several bands a block
    a = a.tocsr()
    a.eliminate_zeros()
    calls = _count_downloads(monkeypatch)
    ref, port, golden = csrgemv_both(tmp_path, a, "N", max_nnzs=600)
    _check(ref, port, golden)
    blocks = fill_row_blocks(a.indptr.astype(np.int64), 600)
    assert [c for c in calls if len(c) == 1] == [(e - r,) for r, e in blocks]
    assert not port[100:140].any()
