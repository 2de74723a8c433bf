"""The port's lib funcs (memset/memcpy/truncate), types and debug
validators against bof_tpu's, on the same inputs, on the CPU.

Every case of tests/test_lib_funcs.py runs here through both packages.
The lib funcs are host byte streams, so every result is bof_tpu's bit for
bit; csrmm under debug_checks is held to scipy at the reference test's
rtol 1e-4 and to bof_tpu at the repo's fp32 rtol 2e-4.  The two float64
gemm cases become the port's: bof_tpu needs JAX's x64 mode for float64
(and raises without it), the port computes float64 natively, within
bof_tpu's 1e-12 of numpy, in this process and in a child process.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import bof_tpu
import bof_tpu_torch
from bof_tpu.lib_funcs import flash_memcpy as ref_memcpy
from bof_tpu.lib_funcs import flash_memset as ref_memset
from bof_tpu.lib_funcs import flash_truncate as ref_truncate
from bof_tpu.sparse.csr import verify_csr_block as ref_verify
from bof_tpu.types import check_fp_dtype as ref_check_fp_dtype
from bof_tpu_torch import mem_array
from bof_tpu_torch.lib_funcs import flash_memcpy, flash_memset, flash_truncate
from bof_tpu_torch.sparse.csr import verify_csr_block
from bof_tpu_torch.types import check_fp_dtype

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ctxs(tmp_path):
    """(bof_tpu context, port context on the CPU): the reference tests'
    configuration in both."""
    ref_cfg = bof_tpu.FlashConfig(scratch_dir=str(tmp_path / "scratch"),
                                  n_io_threads=4, n_compute_threads=2,
                                  program_budget=256 << 20)
    port_cfg = bof_tpu_torch.config_from_reference(
        dataclasses.asdict(ref_cfg), device="cpu")
    ref, port = bof_tpu.FlashContext(ref_cfg), bof_tpu_torch.FlashContext(
        port_cfg)
    yield ref, port
    ref.destroy()
    port.destroy()


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                  np.ascontiguousarray(b).view(np.uint8))


def _pkgs(ctxs):
    """(package, its context, its lib funcs) for bof_tpu, then the port."""
    return ((bof_tpu, ctxs[0], (ref_memset, ref_memcpy, ref_truncate)),
            (bof_tpu_torch, ctxs[1], (flash_memset, flash_memcpy,
                                      flash_truncate)))


def test_flash_memset(ctxs):
    outs = []
    for pkg, ctx, (memset, _, _) in _pkgs(ctxs):
        arr = pkg.flash_empty((10_000,), np.float32, ctx=ctx)
        arr.write_all(np.full(10_000, 3.0, np.float32))
        memset(arr, 0)
        outs.append(arr.read_all())
        pkg.flash_free(arr)
    _same_bits(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], 0.0)


def test_flash_memcpy(ctxs, rng):
    data = rng.standard_normal(5000).astype(np.float32)
    outs = []
    for pkg, ctx, (_, memcpy, _) in _pkgs(ctxs):
        src = pkg.mem_array((5000,), np.float32, data=data, ctx=ctx)
        dst = pkg.flash_empty((5000,), np.float32, ctx=ctx)
        memcpy(dst, src)
        outs.append(dst.read_all())
        pkg.flash_free(dst)
    _same_bits(outs[1], outs[0])
    _same_bits(outs[1], data)


def test_flash_truncate(ctxs):
    outs = []
    for pkg, ctx, (_, _, truncate) in _pkgs(ctxs):
        arr = pkg.flash_empty((1000,), np.int32, ctx=ctx)
        arr.write_all(np.arange(1000, dtype=np.int32))
        small = truncate(arr, 100)
        assert small.shape == (100,)
        outs.append(small.read_all())
        with pytest.raises(ValueError):
            truncate(small, 101)
        pkg.flash_free(arr)
    _same_bits(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], np.arange(100, dtype=np.int32))


def test_check_fp_dtype():
    for dt in (np.float32, np.float64, "float32"):
        assert check_fp_dtype(dt) == ref_check_fp_dtype(dt) == np.dtype(dt)
    for dt in (np.int32, np.float16):
        with pytest.raises(TypeError):
            ref_check_fp_dtype(dt)
        with pytest.raises(TypeError):
            check_fp_dtype(dt)
    from bof_tpu import types as ref_types
    from bof_tpu_torch import types
    for name in ("IDX_DTYPE", "IDX_DEVICE_DTYPE", "FP_DTYPE", "OFFSET_DTYPE",
                 "SUPPORTED_FP"):
        assert getattr(types, name) == getattr(ref_types, name), name
    assert types.IDX_DEVICE_DTYPE is np.int32


def test_verify_csr_block():
    ia = np.array([0, 2, 5], np.int64)
    ja = np.array([1, 3, 0, 2, 4], np.int64)
    for verify in (ref_verify, verify_csr_block):
        verify(ia, ja, 5)  # ok
        with pytest.raises(ValueError):
            verify(ia, ja, 4)  # col out of range
        with pytest.raises(ValueError):
            verify(np.array([0, 3, 1], np.int64), ja[:1], 5)
        with pytest.raises(ValueError):
            verify(ia, ja[:4], 5)  # nnz mismatch


def test_csrmm_with_debug_checks(ctxs, rng):
    import scipy.sparse as sps
    a_sp = sps.random(100, 80, density=0.05, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(1))
    b = rng.standard_normal((80, 8)).astype(np.float32)
    outs = []
    for pkg, ctx, _ in _pkgs(ctxs):
        ctx.config.debug_checks = True
        ctx.config.max_nnzs = 512
        A = pkg.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        B = pkg.mem_array((80, 8), np.float32, data=b, ctx=ctx)
        C = pkg.mem_array((100, 8), np.float32, ctx=ctx)
        pkg.csrmm(A, B, C, ctx=ctx)
        outs.append(C.read_all())
    np.testing.assert_allclose(outs[1], a_sp @ b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-4, atol=1e-5)


def test_gemm_float64_runs_natively(ctxs, rng):
    """bof_tpu without x64 raises a clear error for float64 operands; the
    port computes them in float64 (K1's 'f64' variant on a card, its plain
    version here)."""
    import jax
    a = rng.standard_normal((8, 8))
    b = rng.standard_normal((8, 8))
    if not jax.config.jax_enable_x64:
        A, B, C = (bof_tpu.mem_array((8, 8), np.float64, ctx=ctxs[0])
                   for _ in range(3))
        with pytest.raises(ValueError, match="x64"):
            bof_tpu.gemm(A, B, C, blk=16, ctx=ctxs[0])
    A = mem_array((8, 8), np.float64, data=a, ctx=ctxs[1])
    B = mem_array((8, 8), np.float64, data=b, ctx=ctxs[1])
    C = mem_array((8, 8), np.float64, ctx=ctxs[1])
    bof_tpu_torch.gemm(A, B, C, blk=16, ctx=ctxs[1])
    np.testing.assert_allclose(C.read_all(), a @ b, rtol=1e-12, atol=1e-12)


def test_gemm_float64_subprocess(tmp_path):
    """float64 end to end (the reference's FP_DOUBLE_PRECISION analog) in
    a child process: bof_tpu with JAX_ENABLE_X64=1 and the port, each
    within 1e-12 of numpy, and within 1e-12 of each other."""
    code = """
import numpy as np
import bof_tpu as bt
import bof_tpu_torch as pt
rng = np.random.default_rng(0)
m, n, k = 40, 30, 50
a = rng.standard_normal((m, k)); b = rng.standard_normal((k, n))
outs = []
for pkg, cfg in ((bt, bt.FlashConfig(scratch_dir=%r)),
                 (pt, pt.FlashConfig(scratch_dir=%r, device="cpu"))):
    ctx = pkg.FlashContext(cfg)
    A = pkg.mem_array((m, k), np.float64, data=a, ctx=ctx)
    B = pkg.mem_array((k, n), np.float64, data=b, ctx=ctx)
    C = pkg.mem_array((m, n), np.float64, ctx=ctx)
    pkg.gemm(A, B, C, blk=16, ctx=ctx)
    outs.append(C.read_all())
    ctx.destroy()
for got in outs:
    np.testing.assert_allclose(got, a @ b, rtol=1e-12)
np.testing.assert_allclose(outs[1], outs[0], rtol=1e-12)
print("F64 OK")
""" % (str(tmp_path / "ref"), str(tmp_path / "port"))
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0 and "F64 OK" in r.stdout, r.stderr[-2000:]


def _arange_parent(pkg, ctx):
    return pkg.mem_array((16, 32), np.float32, ctx=ctx,
                         data=np.arange(16 * 32, dtype=np.float32)
                         .reshape(16, 32))


def test_flash_memset_padded_submatrix(ctxs):
    """ld-padded sub-matrix memset does not touch the parent's bytes
    outside the view."""
    it = np.dtype(np.float32).itemsize
    outs = []
    for pkg, ctx, (memset, _, _) in _pkgs(ctxs):
        parent = _arange_parent(pkg, ctx)
        sub = pkg.FlashArray(parent.store, (8, 16), np.float32, "R",
                             offset=(4 * 32 + 8) * it, ld=32, ctx=ctx)
        memset(sub, 0)
        outs.append(parent.read_all())
    want = np.arange(16 * 32, dtype=np.float32).reshape(16, 32)
    want[4:12, 8:24] = 0.0
    _same_bits(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], want)


def test_flash_memcpy_padded_and_mixed_order(ctxs, rng):
    """Padded and layout-changing copies stream through strided scopy /
    host transposition (reference: scopy, flash_file_handle.cpp:718-727)."""
    it = np.dtype(np.float32).itemsize
    sdata = rng.standard_normal((12, 20)).astype(np.float32)
    outs = []
    for pkg, ctx, (_, memcpy, _) in _pkgs(ctxs):
        src_parent = pkg.mem_array((12, 20), np.float32, ctx=ctx, data=sdata)
        dst_parent = pkg.mem_array((10, 24), np.float32, ctx=ctx,
                                   data=np.zeros((10, 24), np.float32))
        src = pkg.FlashArray(src_parent.store, (6, 10), np.float32, "R",
                             offset=(2 * 20 + 3) * it, ld=20, ctx=ctx)
        dst = pkg.FlashArray(dst_parent.store, (6, 10), np.float32, "R",
                             offset=(1 * 24 + 5) * it, ld=24, ctx=ctx)
        memcpy(dst, src)
        np.testing.assert_array_equal(dst.read_all(), src.read_all())
        dp = dst_parent.read_all()
        assert np.count_nonzero(dp) == np.count_nonzero(src.read_all())
        cdst = pkg.mem_array((6, 10), np.float32, order="C",
                             data=np.zeros((6, 10), np.float32), ctx=ctx)
        memcpy(cdst, src)
        np.testing.assert_array_equal(cdst.read_all(), src.read_all())
        outs.append((dp, cdst.read_all()))
    for got, want in zip(outs[1], outs[0]):
        _same_bits(got, want)


def test_flash_memcpy_dense_mixed_order(ctxs, rng):
    """Equal-shape dense arrays with different storage orders copy
    LOGICALLY; transposed-shape pairs keep the byte-reinterpret
    semantics."""
    a = rng.standard_normal((6, 10)).astype(np.float32)
    outs = []
    for pkg, ctx, (_, memcpy, _) in _pkgs(ctxs):
        src = pkg.mem_array((6, 10), np.float32, order="R", data=a, ctx=ctx)
        dst = pkg.mem_array((6, 10), np.float32, order="C",
                            data=np.zeros((6, 10), np.float32), ctx=ctx)
        memcpy(dst, src)
        dst2 = pkg.mem_array((10, 6), np.float32, order="C",
                             data=np.zeros((10, 6), np.float32), ctx=ctx)
        memcpy(dst2, src)
        outs.append((dst.read_all(), dst2.read_all()))
    np.testing.assert_array_equal(outs[1][0], a)
    np.testing.assert_array_equal(outs[1][1], a.T)
    for got, want in zip(outs[1], outs[0]):
        _same_bits(got, want)


def test_flash_memcpy_square_mixed_order_is_logical(ctxs, rng):
    """Square equal-shape mixed-order copies are LOGICAL (the
    byte-reinterpret branch would silently transpose)."""
    a = rng.standard_normal((8, 8)).astype(np.float32)
    outs = []
    for pkg, ctx, (_, memcpy, _) in _pkgs(ctxs):
        src = pkg.mem_array((8, 8), np.float32, order="R", data=a, ctx=ctx)
        dst = pkg.mem_array((8, 8), np.float32, order="C",
                            data=np.zeros((8, 8), np.float32), ctx=ctx)
        memcpy(dst, src)
        outs.append(dst.read_all())
    _same_bits(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], a)
