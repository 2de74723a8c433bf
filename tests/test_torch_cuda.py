"""bof_tpu_torch on a CUDA card: kernels K1, K2 (ELL SpMM) and the ELL
SpMV against their plain versions, and the out-of-core gemm, csrmm and
csrgemv through them against the same calls on the CPU.

These need the card (a CUDA kernel has no CPU mode): they carry the
`cuda` marker and skip where torch.cuda.is_available() is False.  This
file imports neither jax nor bof_tpu, so it runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q

TF32 is off, so the plain versions are full fp32; tolerance rtol 2e-4,
the repo's fp32 invariant (accumulation order differs from cuBLAS).
"""
import itertools
import os

import numpy as np
import pytest
import torch

import bof_tpu_torch
from bof_tpu_torch.ops.matmul_cuda import accum_matmul, accum_matmul_ref
from bof_tpu_torch.sparse.spmm_cuda import (spmm_ell, spmm_ell_ref, spmv_ell,
                                            spmv_ell_ref)

pytestmark = pytest.mark.cuda

LAYOUTS = list(itertools.product([False, True], repeat=3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel K1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_kernel_matches_plain(cuda_device, a_km, b_nk, c_nm):
    """Ragged edges in every dimension, alpha != 1, a non-zero C."""
    rng = np.random.default_rng(7)
    m, n, k = 300, 211, 147
    a_log = rng.standard_normal((m, k), dtype=np.float32)
    b_log = rng.standard_normal((k, n), dtype=np.float32)
    c_log = rng.standard_normal((m, n), dtype=np.float32)
    a = torch.from_numpy(a_log.T.copy() if a_km else a_log).to(cuda_device)
    b = torch.from_numpy(b_log.T.copy() if b_nk else b_log).to(cuda_device)
    got = torch.from_numpy(c_log.T.copy() if c_nm else c_log).to(cuda_device)
    want = got.clone()
    before = accum_matmul.launches
    accum_matmul(got, a, b, 1.5, a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    torch.cuda.synchronize()
    assert accum_matmul.launches == before + 1
    accum_matmul_ref(want, a, b, 1.5, a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("order,ta,tb", [("R", "N", "N"), ("C", "T", "N")])
def test_gemm_on_card_matches_cpu(cuda_device, tmp_path, order, ta, tb):
    """The whole pipeline through K1 against the same files on the CPU,
    with ragged superblocks and beta != 0; K1 runs mB*nB*kB times."""
    rng = np.random.default_rng(8)
    m, n, k, blk = 300, 260, 280, 128
    a_shape = (k, m) if ta == "T" else (m, k)
    b_shape = (n, k) if tb == "T" else (k, n)
    data = {"A": rng.standard_normal(a_shape, dtype=np.float32),
            "B": rng.standard_normal(b_shape, dtype=np.float32),
            "C": rng.standard_normal((m, n), dtype=np.float32)}
    shapes = {"A": a_shape, "B": b_shape, "C": (m, n)}
    out = {}
    for device in ("cpu", "cuda"):
        d = tmp_path / device
        d.mkdir()
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(d / "s")))
        try:
            arrs = []
            for name in "ABC":
                arr = bof_tpu_torch.map_array(
                    os.path.join(d, name), shapes[name], np.float32, order,
                    create=True, ctx=ctx)
                arr.write_all(data[name])
                arrs.append(arr)
            before = accum_matmul.launches
            bof_tpu_torch.gemm(*arrs, alpha=0.5, beta=2.0, transa=ta,
                               transb=tb, blk=blk, ctx=ctx)
            launched = accum_matmul.launches - before
            out[device] = arrs[2].read_all()
        finally:
            ctx.destroy()
        cdiv = lambda x: -(-x // blk)  # noqa: E731
        assert launched == (0 if device == "cpu"
                            else cdiv(m) * cdiv(n) * cdiv(k))
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=2e-4,
                               atol=1e-4)


def _ell(rng, rows, rmax, k, idt, device):
    """A random ELL block with padding slots (va = 0, ja = 0) in every
    row past a random count."""
    counts = rng.integers(0, rmax + 1, rows)
    ja = rng.integers(0, k, (rows, rmax)).astype(idt)
    va = rng.standard_normal((rows, rmax), dtype=np.float32)
    pad = np.arange(rmax)[None, :] >= counts[:, None]
    ja[pad] = 0
    va[pad] = 0.0
    return (torch.from_numpy(ja).to(device), torch.from_numpy(va).to(device))


@pytest.mark.parametrize("idt", [np.int32, np.uint16])
@pytest.mark.parametrize("rows,rmax,k,cb", [(37, 24, 5000, 999),
                                            (16, 64, 65536, 512),
                                            (3, 3000, 700, 6),
                                            (200, 1, 100, 1)])
def test_spmm_ell_kernel_matches_plain(cuda_device, idt, rows, rmax, k, cb):
    """Ragged cb (scalar tail), float4 columns, a row longer than one
    shared-memory stage, rmax 1, both index types."""
    rng = np.random.default_rng(rows * rmax + cb)
    ja, va = _ell(rng, rows, rmax, k, idt, cuda_device)
    b = torch.from_numpy(rng.standard_normal((k, cb), dtype=np.float32)
                         ).to(cuda_device)
    before = spmm_ell.launches
    got = spmm_ell(b, ja, va)
    torch.cuda.synchronize()
    assert spmm_ell.launches == before + 1
    want = spmm_ell_ref(b, ja, va)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("idt", [np.int32, np.uint16])
@pytest.mark.parametrize("rows,rmax", [(1001, 40), (9, 2000)])
def test_spmv_ell_kernel_matches_plain(cuda_device, idt, rows, rmax):
    rng = np.random.default_rng(rows + rmax)
    k = 60000
    ja, va = _ell(rng, rows, rmax, k, idt, cuda_device)
    x = torch.from_numpy(rng.standard_normal(k, dtype=np.float32)
                         ).to(cuda_device)
    before = spmv_ell.launches
    got = spmv_ell(x, ja, va)
    torch.cuda.synchronize()
    assert spmv_ell.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               spmv_ell_ref(x, ja, va).cpu().numpy(),
                               rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("transa,order", [("N", "R"), ("N", "C"),
                                          ("T", "R")])
def test_csrmm_on_card_matches_cpu(cuda_device, tmp_path, transa, order):
    """Out-of-core csrmm through K2 against the same files on the CPU:
    several row blocks and column panels, a ragged cb, beta != 0; 'T'
    goes through csrcsc and recurses on the card."""
    import scipy.sparse as sps
    rng = np.random.default_rng(9)
    m, k, n = 700, 500, 90
    a_sp = sps.random(m, k, density=0.02, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(9))
    b_rows, c_rows = (m, k) if transa == "T" else (k, m)
    b = rng.standard_normal((b_rows, n), dtype=np.float32)
    c0 = rng.standard_normal((c_rows, n), dtype=np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(tmp_path / device),
            sparse_compute="device", max_nnzs=2048, csrmm_cblk_size=36))
        try:
            A = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
            B = bof_tpu_torch.mem_array((b_rows, n), np.float32, order,
                                        data=b, ctx=ctx)
            C = bof_tpu_torch.mem_array((c_rows, n), np.float32, order,
                                        data=c0, ctx=ctx)
            before = spmm_ell.launches
            bof_tpu_torch.csrmm(A, B, C, alpha=0.5, beta=2.0, transa=transa,
                                ctx=ctx)
            launched = spmm_ell.launches - before
            out[device] = C.read_all()
        finally:
            ctx.destroy()
        assert (launched > 0) == (device == "cuda")
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=2e-4,
                               atol=1e-4)


def test_csrgemv_on_card_matches_cpu(cuda_device, tmp_path):
    import scipy.sparse as sps
    a_sp = sps.random(3000, 800, density=0.01, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(4))
    x = np.random.default_rng(4).standard_normal(800, dtype=np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(tmp_path / device),
            max_nnzs=4096))
        try:
            A = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
            before = spmv_ell.launches
            out[device] = bof_tpu_torch.csrgemv(A, x, ctx=ctx)
            assert (spmv_ell.launches > before) == (device == "cuda")
        finally:
            ctx.destroy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=2e-4,
                               atol=1e-4)
