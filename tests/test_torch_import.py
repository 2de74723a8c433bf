"""The port's package boundary: bof_tpu_torch imports torch and never jax
or bof_tpu, asks for its device explicitly, and carries bof_tpu's
configuration across field for field."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bof_tpu
import bof_tpu_torch
from bof_tpu_torch.ops.matmul_cuda import accum_matmul

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bof_tpu_torch")


def test_import_leaves_jax_and_bof_tpu_out():
    code = ("import sys, bof_tpu_torch, bof_tpu_torch.drivers.gemm; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'bof_tpu' or "
            "m.startswith('bof_tpu.')); print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_import_neither_jax_nor_bof_tpu():
    pat = re.compile(r"^\s*(from|import)\s+(jax|bof_tpu)(\.|\s|$)")
    hits = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    for no, line in enumerate(f, 1):
                        if pat.match(line):
                            hits.append(f"{path}:{no}: {line.strip()}")
    assert hits == []


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU-only contract does "
                    "not apply")
    cfg = bof_tpu_torch.FlashConfig(device="cuda",
                                    scratch_dir=str(tmp_path / "s"))
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        a = bof_tpu_torch.mem_array((8, 8), np.float32, ctx=ctx,
                                    data=np.eye(8, dtype=np.float32))
        c = bof_tpu_torch.mem_array((8, 8), np.float32, ctx=ctx)
        with pytest.raises(RuntimeError, match="cuda"):
            bof_tpu_torch.gemm(a, a, c, blk=4, ctx=ctx)
        assert not c.read_all().any(), "nothing may run on the CPU instead"
    finally:
        ctx.destroy()


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((5, 7), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((7, 3), dtype=np.float32))
    c = torch.zeros(5, 3)
    before = accum_matmul.launches
    accum_matmul(c, a, b, 2.0, a_km=False, b_nk=False, c_nm=False)
    assert accum_matmul.launches == before
    np.testing.assert_allclose(c.numpy(), 2.0 * (a @ b).numpy(),
                               rtol=1e-6)


def test_config_from_reference_carries_every_shared_field():
    ref = bof_tpu.FlashConfig(program_budget=123 << 20, gemm_blk_size=64,
                              hbm_budget=5 << 20, pipeline_depth=2,
                              use_o_direct=True, io_backend="python",
                              matmul_precision="high")
    d = dataclasses.asdict(ref)
    port = bof_tpu_torch.config_from_reference(d, device="cpu")
    assert port.device == "cpu"
    port_d = dataclasses.asdict(port)
    dropped = {"device_compute", "fp64_device", "fp64_slices", "gemm_tile"}
    assert set(d) - set(port_d) == dropped
    for key in set(d) - dropped:
        assert port_d[key] == d[key], key
    with pytest.raises(KeyError, match="no_such_field"):
        bof_tpu_torch.config_from_reference(dict(d, no_such_field=1))


def test_native_engine_builds_outside_the_reference_package():
    from bof_tpu_torch.io import native
    lib = native.load_library()
    assert lib is not None
    so = native._build()
    assert so.startswith(native.build_root() + os.sep)
    assert "bof_tpu" + os.sep + "native" not in so
    assert os.path.basename(so).startswith("libbof_io-")


def test_sparse_slice_imports_neither_jax_nor_ml_dtypes():
    code = ("import sys, bof_tpu_torch.sparse, bof_tpu_torch.drivers.csrmm, "
            "bof_tpu_torch.drivers.csrgemv, bof_tpu_torch.drivers.csrcsc, "
            "bof_tpu_torch.drivers.sparse_create, "
            "bof_tpu_torch.drivers.in_mem_sparse; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'bof_tpu')); print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    pat = re.compile(r"^\s*(from|import)\s+ml_dtypes(\.|\s|$)")
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    assert not any(pat.match(line) for line in f), name


@pytest.mark.parametrize("kernel", ["csrmm", "csrgemv"])
def test_sparse_cuda_device_without_card_raises(tmp_path, kernel):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU-only contract does "
                    "not apply")
    import scipy.sparse as sps
    cfg = bof_tpu_torch.FlashConfig(device="cuda",
                                    scratch_dir=str(tmp_path / "s"))
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(
            sps.identity(8, dtype=np.float32, format="csr"), ctx=ctx)
        b = bof_tpu_torch.mem_array((8, 4), np.float32, ctx=ctx,
                                    data=np.ones((8, 4), np.float32))
        c = bof_tpu_torch.mem_array((8, 4), np.float32, ctx=ctx)
        with pytest.raises(RuntimeError, match="cuda"):
            if kernel == "csrmm":
                bof_tpu_torch.csrmm(a, b, c, ctx=ctx)
            else:
                bof_tpu_torch.csrgemv(a, np.ones(8, np.float32), ctx=ctx)
        assert not c.read_all().any(), "nothing may run on the CPU instead"
    finally:
        ctx.destroy()


def test_config_round_trips_non_default_sparse_fields():
    ref = bof_tpu.FlashConfig(max_nnzs=12345, csrmm_cblk_size=96,
                              csrgemv_blk_size=777, sparse_compute="host",
                              sparse_device_impl="pallas",
                              ell_sort_rows=False, ell_idx_narrow=False)
    port = bof_tpu_torch.config_from_reference(dataclasses.asdict(ref))
    for key in ("max_nnzs", "csrmm_cblk_size", "csrgemv_blk_size",
                "sparse_compute", "sparse_device_impl", "ell_sort_rows",
                "ell_idx_narrow"):
        assert getattr(port, key) == getattr(ref, key), key
    assert port.device == "cuda"  # never inferred from the reference
