"""bof_tpu_torch on a CUDA card: kernel K1 against its plain version, and
the out-of-core gemm through K1 against the same gemm on the CPU.

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
