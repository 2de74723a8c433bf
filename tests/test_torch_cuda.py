"""bof_tpu_torch on a CUDA card: kernel K1 (its tensor-core fp32, bf16,
s8 and f64 variants), K2 (ELL SpMM), the ELL SpMV (on fp32, bf16 and int8
values), the k-means pair B7, the row top-k B8 and the block sort B10
against their plain versions, and the out-of-core gemm (fp32, its
transfer modes and float64), csrmm, csrgemv, lloyds_iter, the three
applications, the sample sort and map through them against the same
calls on the CPU (map's torch.sqrt against np.sqrt bit for bit).

These need the card (a CUDA kernel has no CPU mode): they carry the
`cuda` marker and skip where torch.cuda.is_available() is False.  This
file imports neither jax nor bof_tpu, so it runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q

TF32 is off, so the plain versions are full fp32; tolerance rtol 2e-4,
the repo's fp32 invariant (accumulation order differs from cuBLAS).
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

import bof_tpu_torch
from bof_tpu_torch.ops.cuda_lib import build
from bof_tpu_torch.ops.matmul_cuda import (K1_S8_MAX_K, K1_VARIANTS,
                                           accum_matmul, accum_matmul_ref,
                                           accum_matmul_tf32_ref, k1_ldw,
                                           k1_variant, pack_kmajor_ref,
                                           tf32_truncate)
from bof_tpu_torch.ops.kmeans import (lloyd_accumulate,
                                      lloyd_accumulate_ordered_ref,
                                      lloyd_accumulate_ref, lloyd_assign,
                                      lloyd_assign_ref,
                                      lloyd_assign_tf32x3_ref)
from bof_tpu_torch.ops.sort_cuda import (SORT_KINDS, SORT_TILE, bits_of,
                                         canonical_keys, sort_block,
                                         sort_block_ref)
from bof_tpu_torch.ops.topk_cuda import row_topk, row_topk_ref, topk_variant
from bof_tpu_torch.sparse.spmm_cuda import (promote_vals, spmm_ell,
                                            spmm_ell_ref, spmv_ell,
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


def _k1_operands(rng, m, n, k, a_km, b_nk, c_nm, device):
    a_log = rng.standard_normal((m, k), dtype=np.float32)
    b_log = rng.standard_normal((k, n), dtype=np.float32)
    c_log = rng.standard_normal((m, n), dtype=np.float32)
    return [torch.from_numpy(x.T.copy() if t else x).to(device)
            for x, t in ((a_log, a_km), (b_log, b_nk), (c_log, c_nm))]


@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_tensor_core_variant_matches_plain(cuda_device, prec, a_km, b_nk,
                                           c_nm):
    """1000x776x516: no dimension a multiple of the 128x256x16 tiles, but
    16-byte rows, so the TMA + wgmma variant runs.  'highest' (3xTF32)
    within the fp32 tolerance of the plain version; 'default' (one TF32
    pass) within that of its truncating emulation, and within
    2^-10*sqrt(k)*max|A|*max|B|*|alpha| of full fp32 (TF32 keeps 10
    explicit mantissa bits; a sum's error grows as sqrt(k))."""
    rng = np.random.default_rng(11)
    m, n, k, alpha = 1000, 776, 516, 1.5
    a, b, got = _k1_operands(rng, m, n, k, a_km, b_nk, c_nm, cuda_device)
    c0 = got.clone()
    variant = k1_variant(prec)
    assert variant == ("tf32x3" if prec == "highest" else "tf32")
    flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    before = dict(accum_matmul.variant_launches)
    accum_matmul(got, a, b, alpha, prec=prec, **flags)
    torch.cuda.synchronize()
    assert accum_matmul.variant_launches[variant] == before[variant] + 1
    want = accum_matmul_ref(c0.clone(), a, b, alpha, **flags)
    if prec == "highest":
        err = float((got - want).abs().max())
        assert err <= 2e-4 * float(want.abs().max()), err
    else:
        emul = accum_matmul_tf32_ref(c0.clone(), a, b, alpha, **flags)
        err = float((got - emul).abs().max())
        assert err <= 2e-4 * float(emul.abs().max()), err
        limit = 2.0 ** -10 * k ** 0.5 * float(a.abs().max()) \
            * float(b.abs().max()) * alpha
        assert float((got - want).abs().max()) <= limit


def _misaligned(x):
    """A contiguous copy of x whose base is 4 bytes past a 16-byte
    boundary: TMA cannot read it in place."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    y = buf[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 4
    return y


@pytest.mark.parametrize("where", ["odd ld", "A's base", "B's base"])
@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_tensor_core_variant_takes_any_leading_dimension_and_base(
        cuda_device, where, prec, a_km, b_nk, c_nm):
    """Operands TMA cannot read where they lie run on the tensor cores
    after the split pass copies them K-major: 1000x777x513 (every leading
    dimension odd), or 1000x776x516 with A's or B's base 4 bytes off 16.
    The fp32 variant of the tier runs, the pack count moves by the
    operands copied (MN-major, or not readable in place), and the result
    meets test_tensor_core_variant_matches_plain's bounds."""
    rng = np.random.default_rng(17 + a_km + 2 * b_nk + 4 * c_nm)
    m, n, k = (1000, 777, 513) if where == "odd ld" else (1000, 776, 516)
    a, b, got = _k1_operands(rng, m, n, k, a_km, b_nk, c_nm, cuda_device)
    if where == "A's base":
        a = _misaligned(a)
    elif where == "B's base":
        b = _misaligned(b)
    readable = [x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
                for x in (a, b)]
    want_packs = int(a_km or not readable[0]) + int(not b_nk or
                                                    not readable[1])
    c0 = got.clone()
    flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    variant = "tf32x3" if prec == "highest" else "tf32"
    before = (accum_matmul.variant_launches[variant],
              accum_matmul.tf32_packs)
    accum_matmul(got, a, b, 1.5, prec=prec, **flags)
    torch.cuda.synchronize()
    assert (accum_matmul.variant_launches[variant],
            accum_matmul.tf32_packs) == (before[0] + 1,
                                         before[1] + want_packs)
    want = accum_matmul_ref(c0.clone(), a, b, 1.5, **flags)
    if prec == "highest":
        assert float((got - want).abs().max()) <= \
            2e-4 * float(want.abs().max())
    else:
        emul = accum_matmul_tf32_ref(c0.clone(), a, b, 1.5, **flags)
        assert float((got - emul).abs().max()) <= \
            2e-4 * float(emul.abs().max())
        assert float((got - want).abs().max()) <= 2.0 ** -10 * k ** 0.5 \
            * float(a.abs().max()) * float(b.abs().max()) * 1.5


def test_tf32_operands_are_truncated(cuda_device):
    """The 3xTF32 split (hi = the raw operand, lo = x - truncate(x))
    assumes wgmma drops the 13 low mantissa bits of a tf32 operand: with
    A = I, one pass returns B rounded exactly as wgmma rounds it."""
    rng = np.random.default_rng(12)
    n = 128
    a = torch.eye(n, device=cuda_device)
    b = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)
                         ).to(cuda_device)
    c = torch.zeros(n, n, device=cuda_device)
    accum_matmul(c, a, b, 1.0, a_km=False, b_nk=False, c_nm=False,
                 prec="default")
    torch.cuda.synchronize()
    assert torch.equal(c, tf32_truncate(b))
    assert not torch.equal(c, b)


def test_variant_launch_counters(cuda_device):
    """One launch of each variant moves its own count and the total; the
    ragged 100x77x51 (rows TMA cannot read) runs on the tensor cores too."""
    rng = np.random.default_rng(13)
    before = (accum_matmul.launches, dict(accum_matmul.variant_launches))
    for (m, n, k), prec in (((256, 256, 64), "highest"),
                            ((256, 256, 64), "default"),
                            ((100, 77, 51), "highest")):
        a, b, c = _k1_operands(rng, m, n, k, False, False, False,
                               cuda_device)
        accum_matmul(c, a, b, 1.0, a_km=False, b_nk=False, c_nm=False,
                     prec=prec)
    torch.cuda.synchronize()
    assert accum_matmul.launches == before[0] + 3
    assert {v: accum_matmul.variant_launches[v] - before[1][v]
            for v in before[1]} == {"tf32x3": 2, "tf32": 1, "bf16": 0,
                                    "s8": 0, "s8_i32": 0, "f64": 0}
    assert tuple(before[1]) == K1_VARIANTS


def _lowp_operands(rng, m, n, k, a_km, b_nk, c_nm, dtype, device):
    """Storage-major bf16 (rounded from normals) or int8 (uniform in
    [-127, 127]) A and B, and an fp32 C."""
    def op(shape, t):
        if dtype == torch.int8:
            x = rng.integers(-127, 128, shape).astype(np.int8)
            x = torch.from_numpy(x)
        else:
            x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                 ).to(torch.bfloat16)
        return (x.T.contiguous() if t else x).to(device)
    c = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32))
    return (op((m, k), a_km), op((k, n), b_nk),
            (c.T.contiguous() if c_nm else c).to(device))


@pytest.mark.parametrize("shape", [(300, 211, 147), (1000, 776, 516),
                                   (129, 5, 1027), (512, 384, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_lowp_variant_matches_plain(cuda_device, shape, dtype, a_km, b_nk,
                                    c_nm):
    """K1 'bf16' and 's8' on every layout, at ragged shapes whose leading
    dimensions are not multiples of 16 bytes (every operand packed) and at
    16-byte aligned ones (read in place by TMA where K-major: nothing
    packed at a_km=0, b_nk=1): 'bf16' within the fp32 tolerance of the
    plain version (exact products, another summation order), 's8' bit for
    bit (an exact int32 sum, then the same two fp32 roundings).  The pack
    count moves by the operands that are MN-major or not 16-byte rows."""
    rng = np.random.default_rng(sum(shape) + a_km + 2 * b_nk + 4 * c_nm)
    m, n, k = shape
    a, b, got = _lowp_operands(rng, m, n, k, a_km, b_nk, c_nm, dtype,
                               cuda_device)
    alpha = 1.5 if dtype == torch.bfloat16 else 3.0517578125e-05 * 1.37
    flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    variant = k1_variant("highest", dtype=dtype)
    assert variant == ("bf16" if dtype == torch.bfloat16 else "s8")
    want = accum_matmul_ref(got.clone(), a, b, alpha, **flags)
    before = accum_matmul.variant_launches[variant]
    packs = accum_matmul.lowp_packs
    accum_matmul(got, a, b, alpha, **flags)
    torch.cuda.synchronize()
    assert accum_matmul.variant_launches[variant] == before + 1
    rows_ok = (a.shape[1] * a.element_size() % 16 == 0,
               b.shape[1] * b.element_size() % 16 == 0)
    assert accum_matmul.lowp_packs - packs == int(a_km or not rows_ok[0]) \
        + int(not b_nk or not rows_ok[1])
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        err = float((got - want).abs().max())
        assert err <= 2e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("a_km,b_nk", list(itertools.product([False, True],
                                                             repeat=2)))
def test_lowp_pack_pass_is_its_plain_version(cuda_device, dtype, a_km, b_nk):
    """The kernel on operands it packs itself gives the same bits as on
    K-major copies made by pack_kmajor_ref (read in place, nothing
    packed): the same products summed in the same order."""
    rng = np.random.default_rng(17 + a_km + 2 * b_nk)
    m, n, k = 384, 272, 1008  # 16-byte rows in both types
    a, b, c = _lowp_operands(rng, m, n, k, a_km, b_nk, False, dtype,
                             cuda_device)
    alpha = 0.75
    got = accum_matmul(c.clone(), a, b, alpha, a_km=a_km, b_nk=b_nk,
                       c_nm=False)
    a_k = pack_kmajor_ref(a, mn_major=a_km, ld=k)
    b_k = pack_kmajor_ref(b, mn_major=not b_nk, ld=k)
    packs = accum_matmul.lowp_packs
    want = accum_matmul(c.clone(), a_k, b_k, alpha, a_km=False, b_nk=True,
                        c_nm=False)
    torch.cuda.synchronize()
    assert accum_matmul.lowp_packs == packs
    assert torch.equal(got, want)


def test_s8_refuses_a_large_k_on_the_card(cuda_device):
    """K above 2^17 could overflow the int32 sum: the wrapper raises, and
    the entry point itself refuses it without launching."""
    k = K1_S8_MAX_K + 16
    a = torch.ones((16, k), dtype=torch.int8, device=cuda_device)
    b = torch.ones((16, k), dtype=torch.int8, device=cuda_device)
    c = torch.zeros((16, 16), device=cuda_device)
    with pytest.raises(ValueError, match="overflow"):
        accum_matmul(c, a, b, 1.0, a_km=False, b_nk=True, c_nm=False)
    rc = build().bof_accum_matmul_lowp(
        c.data_ptr(), a.data_ptr(), b.data_ptr(), 1.0, 16, 16, k, 0, 1, 0,
        k, k, 16, 1, None, None, k1_ldw(k, 1),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc != 0
    assert not c.any()


def test_gemm_downloads_c_through_the_pinned_ring(cuda_device, tmp_path,
                                                  monkeypatch):
    """One gemm of 2 x 2 x 2 blocks into a file-backed C: its bytes equal
    those of the download the ring replaced (one `from_device` of each
    whole block, `test_torch_d2h_ring._whole_block`), every DtoH copy
    under torch.profiler goes to page-locked memory on a stream no K1
    launch runs on, and `d2h.ring_bytes` counts C's bytes.  Slots of
    1 MiB split each 4 MiB block into four runs."""
    from torch.profiler import ProfilerActivity, profile

    from bof_tpu_torch.ops import device as dev
    from bof_tpu_torch.utils import METRICS
    from test_torch_d2h_ring import _whole_block
    monkeypatch.setattr(dev, "RING_SLOT_BYTES", 1 << 20)
    m = n = k = 2048
    blk = 1024
    rng = np.random.default_rng(18)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)

    def run(tag, traced):
        d = tmp_path / tag
        d.mkdir()
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device="cuda", scratch_dir=str(d / "s")))
        try:
            A = bof_tpu_torch.mem_array((m, k), np.float32, data=a, ctx=ctx)
            B = bof_tpu_torch.mem_array((k, n), np.float32, data=b, ctx=ctx)
            C = bof_tpu_torch.map_array(str(d / "C"), (m, n), np.float32,
                                        create=True, ctx=ctx)
            ring0 = METRICS.get("d2h.ring_bytes")
            if traced:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    bof_tpu_torch.gemm(A, B, C, alpha=0.5, blk=blk, ctx=ctx)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(str(d / "trace.json"))
            else:
                bof_tpu_torch.gemm(A, B, C, alpha=0.5, blk=blk, ctx=ctx)
            moved = METRICS.get("d2h.ring_bytes") - ring0
        finally:
            ctx.destroy()
        return (d / "C").read_bytes(), moved, d / "trace.json"

    got, moved, trace = run("ring", True)
    assert moved == m * n * 4
    events = json.loads(trace.read_text())["traceEvents"]
    dtoh = [e for e in events if e.get("cat") == "gpu_memcpy"
            and "DtoH" in e["name"]]
    k1_streams = {e["args"]["stream"] for e in events
                  if e.get("cat") == "kernel" and "accum" in e["name"]}
    assert len(dtoh) >= 16 and k1_streams
    assert all("Pinned" in e["name"] for e in dtoh), {e["name"]
                                                      for e in dtoh}
    assert not {e["args"]["stream"] for e in dtoh} & k1_streams
    monkeypatch.setattr(dev.D2HRing, "download", _whole_block)
    want, moved, _ = run("whole", False)
    assert moved == 0
    assert got == want
    np.testing.assert_allclose(
        np.frombuffer(got, np.float32).reshape(m, n),
        0.5 * (a.astype(np.float64) @ b), rtol=2e-4, atol=2e-3)


def _record_uploads(monkeypatch):
    """Wrap `to_device`: the list gets (bytes, source page-locked) of
    every upload from now on."""
    from bof_tpu_torch.ops import device as dev
    seen = []
    real = dev.to_device

    def recording(x, device):
        src = torch.from_numpy(np.ascontiguousarray(x))
        seen.append((src.nbytes, src.is_pinned()))
        return real(x, device)

    monkeypatch.setattr(dev, "to_device", recording)
    return seen


def test_gemm_uploads_cached_tiles_page_locked(cuda_device, tmp_path,
                                               monkeypatch):
    """A gemm of 2 x 2 x 2 blocks from files whose Program Cache holds
    every tile, called twice: on the second call every upload reads a
    page-locked source (`h2d.locked_bytes` == `h2d.bytes`), each tile's
    buffer was locked once over both calls, and C is byte-equal to the
    first call's."""
    from bof_tpu_torch.utils import METRICS
    m = n = k = 2048
    blk = 1024
    rng = np.random.default_rng(20)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    a.tofile(str(tmp_path / "A"))
    b.tofile(str(tmp_path / "B"))
    seen = _record_uploads(monkeypatch)
    ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
        device="cuda", scratch_dir=str(tmp_path / "s"),
        io_backend="native", program_budget=256 << 20))
    try:
        A = bof_tpu_torch.map_array(str(tmp_path / "A"), (m, k), np.float32,
                                    ctx=ctx)
        B = bof_tpu_torch.map_array(str(tmp_path / "B"), (k, n), np.float32,
                                    ctx=ctx)
        out = []
        for _ in range(2):
            C = bof_tpu_torch.mem_array((m, n), np.float32, ctx=ctx)
            seen.clear()
            h0 = (METRICS.get("h2d.bytes"), METRICS.get("h2d.locked_bytes"))
            bof_tpu_torch.gemm(A, B, C, alpha=0.5, blk=blk, ctx=ctx)
            moved = (METRICS.get("h2d.bytes") - h0[0],
                     METRICS.get("h2d.locked_bytes") - h0[1])
            out.append(C.read_all().tobytes())
        stats = ctx.pin_cache_stats()
    finally:
        ctx.destroy()
    tile = blk * blk * 4
    assert moved[0] == moved[1] and moved[0] >= 8 * tile
    assert seen and all(pinned for _, pinned in seen), seen
    assert stats["misses"] == stats["locks"] == 8
    assert stats["lock_fails"] == 0
    assert out[0] == out[1]
    np.testing.assert_allclose(
        np.frombuffer(out[1], np.float32).reshape(m, n),
        0.5 * (a.astype(np.float64) @ b), rtol=2e-4, atol=2e-3)


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


def test_spmm_ell_rejects_a_cb_past_one_grid(cuda_device):
    """65535 slabs of 64 columns fill the grid's y dimension: one column
    more fails to launch, and the wrapper raises without counting."""
    ja = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    va = torch.ones((1, 1), device=cuda_device)
    b = torch.ones((1, 65535 * 64 + 1), device=cuda_device)
    before = spmm_ell.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        spmm_ell(b, ja, va)
    assert spmm_ell.launches == before


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


def _lowp_values(va, vdt):
    """va (fp32, NaN in padding) in the transfer modes' value types:
    (va, None) for fp32, bf16 (NaN kept), or int8 with its row scales
    (padding 0: the kernel must not read it either way)."""
    if vdt == "f32":
        return va, None
    if vdt == "bf16":
        return va.to(torch.bfloat16), None
    fin = va.nan_to_num()
    scale = (fin.abs().amax(1) / 127).clamp_min(1e-30)
    q = torch.round(fin / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale.contiguous()


def _placed_ell(rng, rows, rmax, k, idt, device, mega=0):
    """An ELL band under the kernels' contract: counts with empty rows
    (and `mega` rows at the full rmax), padding slots past each count
    holding ja 0 and va NaN, which a kernel that read them would turn
    into a NaN."""
    counts = rng.integers(0, rmax + 1, rows)
    counts[::5] = 0
    counts[1:1 + mega] = rmax
    ja = rng.integers(0, k, (rows, rmax)).astype(idt)
    va = rng.standard_normal((rows, rmax), dtype=np.float32)
    pad = np.arange(rmax)[None, :] >= counts[:, None]
    ja[pad] = 0
    va[pad] = np.nan
    return [torch.from_numpy(x).to(device)
            for x in (ja, va, counts.astype(np.int32))]


def _sentinel_out(rng, rows, width, device):
    total = 2 * rows + 3
    perm = rng.permutation(total)
    rows_idx = torch.from_numpy(perm[:rows].astype(np.int32)).to(device)
    out = torch.full((total,) + width, -7.25, device=device)
    return rows_idx, out, torch.from_numpy(np.sort(perm[rows:])).to(device)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("idt,rows,rmax,k,cb,mega", [
    (np.int32, 40, 24, 5000, 37, 0),       # ragged cb: the scalar tail
    (np.uint16, 40, 24, 5000, 512, 0),     # float4 columns, uint16
    (np.int32, 512, 256, 4096, 256, 0),    # a csrmm band, every row resident
    (np.int32, 3, 3000, 700, 64, 2),       # mega-rows: staged in chunks
    (np.uint16, 2, 16384, 65536, 999, 1)])  # uint16, cb 999, rmax 16384
def test_spmm_ell_contract_kernel_matches_plain(cuda_device, alpha, idt, rows,
                                                rmax, k, cb, mega):
    """K2 with counts, a permuted rows into a larger out and alpha: the
    named rows equal the plain version's, every other row keeps its
    sentinel, and no padding slot is read."""
    rng = np.random.default_rng(rows * rmax + cb)
    ja, va, counts = _placed_ell(rng, rows, rmax, k, idt, cuda_device, mega)
    b = torch.from_numpy(rng.standard_normal((k, cb), dtype=np.float32)
                         ).to(cuda_device)
    rows_idx, got, untouched = _sentinel_out(rng, rows, (cb,), cuda_device)
    want = got.clone()
    where = dict(counts=counts, rows=rows_idx, alpha=alpha)
    before = spmm_ell.launches
    assert spmm_ell(b, ja, va, out=got, **where) is got
    torch.cuda.synchronize()
    assert spmm_ell.launches == before + 1
    spmm_ell_ref(b, ja, va, out=want, **where)
    # fp32 sums of up to rmax terms in another order: an error that grows
    # as sqrt(rmax) times the largest product
    atol = 1e-5 * rmax ** 0.5 * float(va.nan_to_num().abs().max()) \
        * float(b.abs().max()) * alpha
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=atol)
    assert bool(torch.all(got[untouched] == -7.25))


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("idt", [np.int32, np.uint16])
@pytest.mark.parametrize("rows,rmax", [(1001, 16), (700, 40), (300, 128),
                                       (257, 256), (9, 2000), (50, 7)])
def test_spmv_ell_contract_kernel_matches_plain(cuda_device, alpha, idt,
                                                rows, rmax):
    """The SpMV with counts, a permuted rows and alpha, at row groups of
    4 to 32 lanes and the scalar path (rmax 7)."""
    rng = np.random.default_rng(rows + rmax)
    k = 60000
    ja, va, counts = _placed_ell(rng, rows, rmax, k, idt, cuda_device)
    x = torch.from_numpy(rng.standard_normal(k, dtype=np.float32)
                         ).to(cuda_device)
    rows_idx, got, untouched = _sentinel_out(rng, rows, (), cuda_device)
    want = got.clone()
    where = dict(counts=counts, rows=rows_idx, alpha=alpha)
    before = spmv_ell.launches
    assert spmv_ell(x, ja, va, out=got, **where) is got
    torch.cuda.synchronize()
    assert spmv_ell.launches == before + 1
    spmv_ell_ref(x, ja, va, out=want, **where)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=1e-4)
    assert bool(torch.all(got[untouched] == -7.25))


@pytest.mark.parametrize("vdt", ["bf16", "s8"])
@pytest.mark.parametrize("idt,rows,rmax,k,cb,mega", [
    (np.int32, 40, 24, 5000, 37, 0),
    (np.uint16, 40, 24, 5000, 512, 0),
    (np.uint16, 24, 64, 65536, 999, 0),
    (np.int32, 512, 256, 4096, 256, 0),
    (np.int32, 3, 3000, 700, 64, 2)])
def test_spmm_ell_lowp_values_match_plain(cuda_device, vdt, idt, rows, rmax,
                                          k, cb, mega):
    """K2 on bf16 and on (int8, row scale) values through the contract
    (counts, permuted rows into a sentinel-filled out, alpha 0.5); cb 37
    and 999 take the scalar column path, uint16 with cb 999 and k 65536
    as csrmm 'T' through csrcsc calls it."""
    rng = np.random.default_rng(rows * rmax + cb + 1)
    ja, va, counts = _placed_ell(rng, rows, rmax, k, idt, cuda_device, mega)
    va, scale = _lowp_values(va, vdt)
    b = torch.from_numpy(rng.standard_normal((k, cb), dtype=np.float32)
                         ).to(cuda_device)
    rows_idx, got, untouched = _sentinel_out(rng, rows, (cb,), cuda_device)
    want = got.clone()
    where = dict(counts=counts, rows=rows_idx, alpha=0.5, va_scale=scale)
    before = dict(spmm_ell.variant_launches)
    spmm_ell(b, ja, va, out=got, **where)
    torch.cuda.synchronize()
    assert spmm_ell.variant_launches[vdt] == before[vdt] + 1
    spmm_ell_ref(b, ja, va, out=want, **where)
    vmax = float(promote_vals(va, scale).nan_to_num().abs().max())
    atol = 1e-5 * rmax ** 0.5 * vmax * float(b.abs().max()) * 0.5
    assert torch.isfinite(got[rows_idx.long()]).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=atol)
    assert bool(torch.all(got[untouched] == -7.25))


@pytest.mark.parametrize("vdt", ["bf16", "s8"])
@pytest.mark.parametrize("idt", [np.int32, np.uint16])
@pytest.mark.parametrize("rows,rmax", [(1001, 16), (300, 128), (257, 256),
                                       (50, 7)])
def test_spmv_ell_lowp_values_match_plain(cuda_device, vdt, idt, rows, rmax):
    """The SpMV on bf16 and (int8, row scale) values: vector loads of 4
    values (8 or 4 bytes) and the scalar path (rmax 7)."""
    rng = np.random.default_rng(rows + rmax + 1)
    k = 60000
    ja, va, counts = _placed_ell(rng, rows, rmax, k, idt, cuda_device)
    va, scale = _lowp_values(va, vdt)
    x = torch.from_numpy(rng.standard_normal(k, dtype=np.float32)
                         ).to(cuda_device)
    rows_idx, got, untouched = _sentinel_out(rng, rows, (), cuda_device)
    want = got.clone()
    where = dict(counts=counts, rows=rows_idx, alpha=0.5, va_scale=scale)
    before = dict(spmv_ell.variant_launches)
    spmv_ell(x, ja, va, out=got, **where)
    torch.cuda.synchronize()
    assert spmv_ell.variant_launches[vdt] == before[vdt] + 1
    spmv_ell_ref(x, ja, va, out=want, **where)
    assert torch.isfinite(got[rows_idx.long()]).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=1e-4)
    assert bool(torch.all(got[untouched] == -7.25))


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("xfer,c_xfer", [("bfloat16", "float32"),
                                         ("int8", "float32"),
                                         ("float32", "bfloat16"),
                                         ("int8", "bfloat16")])
def test_gemm_transfer_modes_on_card_match_cpu(cuda_device, tmp_path, xfer,
                                               c_xfer):
    """The pipeline in each transfer mode through K1 'bf16' or 's8'
    against the same files on the CPU (order C, T/N, beta != 0, ragged
    superblocks).  int8 matches bit for bit (the same host rounding, an
    exact int32 sum, the same fp32 roundings); bf16 tiles within the fp32
    tolerance (summation order); a bf16 C download within one bf16 ulp."""
    rng = np.random.default_rng(18)
    m, n, k, blk = 300, 260, 280, 128
    data = {"A": rng.standard_normal((k, m), dtype=np.float32),
            "B": rng.standard_normal((k, n), dtype=np.float32),
            "C": rng.standard_normal((m, n), dtype=np.float32)}
    shapes = {"A": (k, m), "B": (k, n), "C": (m, n)}
    out = {}
    variant = "s8" if xfer == "int8" else "bf16" if xfer == "bfloat16" \
        else "tf32x3"
    for device in ("cpu", "cuda"):
        d = tmp_path / device
        d.mkdir()
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(d / "s"), transfer_dtype=xfer,
            c_transfer_dtype=c_xfer))
        try:
            arrs = []
            for name in "ABC":
                arr = bof_tpu_torch.map_array(
                    os.path.join(d, name), shapes[name], np.float32, "C",
                    create=True, ctx=ctx)
                arr.write_all(data[name])
                arrs.append(arr)
            before = accum_matmul.variant_launches[variant]
            bof_tpu_torch.gemm(*arrs, alpha=0.5, beta=2.0, transa="T",
                               blk=blk, ctx=ctx)
            launched = accum_matmul.variant_launches[variant] - before
            out[device] = arrs[2].read_all()
        finally:
            ctx.destroy()
        assert launched == (0 if device == "cpu" else 3 * 3 * 3)
    if xfer == "int8":
        np.testing.assert_array_equal(out["cuda"], out["cpu"])
    elif c_xfer == "bfloat16":
        assert (np.abs(out["cuda"].astype(np.float64) - out["cpu"])
                <= _bf16_ulp(np.maximum(np.abs(out["cuda"]),
                                        np.abs(out["cpu"])))).all()
    else:
        np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                                   atol=2e-4 * np.abs(out["cpu"]).max())


@pytest.mark.parametrize("xfer,c_xfer", [("bfloat16", "float32"),
                                         ("int8", "float32"),
                                         ("float32", "bfloat16"),
                                         ("int8", "bfloat16")])
def test_sparse_transfer_modes_on_card_match_cpu(cuda_device, tmp_path,
                                                 xfer, c_xfer):
    """csrmm 'N' (K2 on bf16 or int8 values, the bf16 download) and, for
    the value modes, csrgemv 'N' against the same calls on the CPU."""
    import scipy.sparse as sps
    rng = np.random.default_rng(19)
    m, k, n = 700, 500, 90
    a_sp = sps.random(m, k, density=0.02, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(19))
    b = rng.standard_normal((k, n), dtype=np.float32)
    x = rng.standard_normal(k, dtype=np.float32)
    vkind = {"float32": "f32", "bfloat16": "bf16", "int8": "s8"}[xfer]
    out, y = {}, {}
    for device in ("cpu", "cuda"):
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(tmp_path / device),
            sparse_compute="device", max_nnzs=2048, csrmm_cblk_size=36,
            transfer_dtype=xfer, c_transfer_dtype=c_xfer))
        try:
            A = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
            B = bof_tpu_torch.mem_array((k, n), np.float32, data=b, ctx=ctx)
            C = bof_tpu_torch.mem_array((m, n), np.float32, ctx=ctx)
            before = (spmm_ell.variant_launches[vkind],
                      spmv_ell.variant_launches[vkind])
            bof_tpu_torch.csrmm(A, B, C, alpha=0.5, ctx=ctx)
            out[device] = C.read_all()
            y[device] = bof_tpu_torch.csrgemv(A, x, ctx=ctx)
            launched = (spmm_ell.variant_launches[vkind] - before[0],
                        spmv_ell.variant_launches[vkind] - before[1])
        finally:
            ctx.destroy()
        assert (min(launched) > 0) == (device == "cuda")
    if c_xfer == "bfloat16":
        prod = np.abs(out["cpu"].astype(np.float64)) / 0.5 * (1 + 2.0 ** -7)
        assert (np.abs(out["cuda"].astype(np.float64) - out["cpu"])
                <= 0.5 * _bf16_ulp(prod)).all()
    else:
        np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                                   atol=2e-4 * np.abs(out["cpu"]).max())
    np.testing.assert_allclose(y["cuda"], y["cpu"], rtol=0,
                               atol=2e-4 * np.abs(y["cpu"]).max())


# ------------------------------------------------ K1 'f64' (DMMA) and B7

def _f64_limit(a, b, alpha, a_km, b_nk, c_nm):
    """bof_tpu's scaled fp64 bound (tests/test_gemm64.py:76-80), per
    element of C in its storage layout: 1e-12 * k * max|row of op(A)| *
    max|column of op(B)| * |alpha|."""
    opa = a.T if a_km else a
    opb = b.T if b_nk else b
    lim = 1e-12 * opa.shape[1] * abs(alpha) * (
        opa.abs().amax(1)[:, None] * opb.abs().amax(0)[None, :])
    return lim.T if c_nm else lim


@pytest.mark.parametrize("shape", [(300, 211, 147), (1000, 776, 516),
                                   (129, 135, 7), (250, 131, 17)])
@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_f64_variant_matches_plain(cuda_device, shape, a_km, b_nk, c_nm):
    """K1 'f64' on every layout at ragged shapes (no dimension a multiple
    of the 128x128x16 tiles or of 16, K below 16; odd leading dimensions),
    alpha -1.5 and a non-zero C, within bof_tpu's scaled fp64 bound of the
    float64 plain version; only the 'f64' count moves; a second launch on
    the same inputs gives the same bits."""
    rng = np.random.default_rng(31 + a_km + 2 * b_nk + 4 * c_nm)
    m, n, k = shape
    a, b, got = [torch.from_numpy(x.T.copy() if t else x).to(cuda_device)
                 for x, t in ((rng.standard_normal((m, k)), a_km),
                              (rng.standard_normal((k, n)), b_nk),
                              (rng.standard_normal((m, n)), c_nm))]
    alpha = -1.5
    flags = dict(a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    for prec in ("highest", "default"):
        assert k1_variant(prec, dtype=torch.float64) == "f64"
    want = accum_matmul_ref(got.clone(), a, b, alpha, **flags)
    assert want.dtype == torch.float64
    again = got.clone()
    before = dict(accum_matmul.variant_launches)
    accum_matmul(got, a, b, alpha, **flags)
    torch.cuda.synchronize()
    moved = {v: accum_matmul.variant_launches[v] - before[v] for v in before}
    assert moved == dict.fromkeys(K1_VARIANTS, 0) | {"f64": 1}
    assert bool(((got - want).abs()
                 <= _f64_limit(a, b, alpha, a_km, b_nk, c_nm)).all())
    accum_matmul(again, a, b, alpha, **flags)
    torch.cuda.synchronize()
    assert torch.equal(again, got), "two launches differ"


@pytest.mark.parametrize("shape,pads", [
    ((200, 131, 77), (3, 5, 7)),   # odd and even lds, odd extents
    ((201, 131, 77), (3, 5, 7)),   # every ld even, every extent odd
    ((200, 132, 78), (3, 5, 7)),   # every ld odd
    ((200, 132, 78), (2, 4, 6))])  # every ld and extent even
@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_f64_kernel_takes_any_leading_dimension(cuda_device, shape, pads,
                                                a_km, b_nk, c_nm):
    """The entry point on operands whose storage rows are wider than the
    matrix (leading dimensions padded by `pads` elements): an odd leading
    dimension takes 8-byte copies, an even one 16-byte copies, and with an
    odd extent along the storage rows the last of a row's 16-byte copies
    reads one element and zero-fills the other.  Only the named columns
    are read, and C's padding keeps its sentinel."""
    rng = np.random.default_rng(41 + a_km + 2 * b_nk + 4 * c_nm)
    (m, n, k), alpha = shape, 0.75

    def padded(rows, cols, pad):
        full = torch.from_numpy(rng.standard_normal((rows, cols + pad))
                                ).to(cuda_device)
        return full, full[:, :cols]
    a_full, a = padded(*((k, m) if a_km else (m, k)), pads[0])
    b_full, b = padded(*((n, k) if b_nk else (k, n)), pads[1])
    c_full, c = padded(*((n, m) if c_nm else (m, n)), pads[2])
    c_full[:, c.shape[1]:] = -1234.5
    want = accum_matmul_ref(c.contiguous(), a.contiguous(), b.contiguous(),
                            alpha, a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    rc = build().bof_accum_matmul_f64(
        c_full.data_ptr(), a_full.data_ptr(), b_full.data_ptr(), alpha, m, n,
        k, int(a_km), int(b_nk), int(c_nm), a_full.shape[1], b_full.shape[1],
        c_full.shape[1], torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert bool(((c - want).abs() <= _f64_limit(
        a, b, alpha, a_km, b_nk, c_nm)).all())
    assert bool((c_full[:, c.shape[1]:] == -1234.5).all())


@pytest.mark.parametrize("order,ta,tb", [("R", "N", "T"), ("C", "T", "N")])
def test_gemm64_on_card_matches_cpu(cuda_device, tmp_path, order, ta, tb):
    """float64 gemm through the pipeline on the card (every K1 launch
    'f64') against the same files on the CPU, ragged superblocks, beta."""
    rng = np.random.default_rng(9)
    m, n, k, blk = 300, 260, 280, 128
    a_shape = (k, m) if ta == "T" else (m, k)
    b_shape = (n, k) if tb == "T" else (k, n)
    data = {"A": rng.standard_normal(a_shape),
            "B": rng.standard_normal(b_shape),
            "C": rng.standard_normal((m, n))}
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
                    os.path.join(d, name), shapes[name], np.float64, order,
                    create=True, ctx=ctx)
                arr.write_all(data[name])
                arrs.append(arr)
            before = accum_matmul.variant_launches["f64"]
            bof_tpu_torch.gemm64(*arrs, alpha=-1.5, beta=0.5, transa=ta,
                                 transb=tb, blk=blk, ctx=ctx)
            launched = accum_matmul.variant_launches["f64"] - before
            out[device] = arrs[2].read_all()
        finally:
            ctx.destroy()
        assert launched == (0 if device == "cpu" else 3 * 3 * 3)
    opa = data["A"].T if ta == "T" else data["A"]
    opb = data["B"].T if tb == "T" else data["B"]
    scale = np.abs(opa).max(1)[:, None] * np.abs(opb).max(0)[None, :]
    assert (np.abs(out["cuda"] - out["cpu"]) <= 1e-12 * k * 1.5 * scale
            ).all()


def _near_tie(p, c, got, want):
    """Where two label vectors differ, the float64 partial distances of
    the two centers are within 1e-5 * (|p|^2 + max|c|^2) of each other."""
    diff = (got != want).nonzero().flatten()
    if diff.numel() == 0:
        return True
    p64, c64 = p[diff].double(), c.double()
    pd = (c64 * c64).sum(1)[None, :] - 2.0 * p64 @ c64.T
    rows = torch.arange(diff.numel(), device=p.device)
    gap = (pd[rows, got[diff].long()] - pd[rows, want[diff].long()]).abs()
    scale = (p64 * p64).sum(1) + float((c64 * c64).sum(1).max())
    return bool((gap <= 1e-5 * scale).all())


def _blobs(rng, bn, d, k, device):
    true = rng.standard_normal((k, d)).astype(np.float32) * 3
    p = true[rng.integers(0, k, bn)] + rng.standard_normal(
        (bn, d)).astype(np.float32)
    c = true + 0.1 * rng.standard_normal((k, d)).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(p)).to(device),
            torch.from_numpy(np.ascontiguousarray(c)).to(device))


@pytest.mark.parametrize("bn,d,k,skew", [(1000, 33, 7, None),
                                         (1, 16, 5, None),
                                         (4096, 128, 300, None),
                                         (2000, 8, 1, None),
                                         (777, 200, 129, None),
                                         (3001, 24, 5000, None),
                                         (2500, 40, 64, "one"),
                                         (5000, 16, 64, "half")])
def test_lloyd_kernels_match_plain(cuda_device, bn, d, k, skew):
    """B7 at ragged shapes (k not a multiple of the 128-center tile, d not
    of the 8-wide slab, bn = 1 and bn not a multiple of the 1024-label
    chunk, d past one 128-feature pass, k 5000 past the shared-memory
    count table): labels equal the plain version's but at near-ties, mind
    within 1e-5 * (|p|^2 + max|c|^2); then the accumulate on those labels,
    or with `skew` on every point in one center ("one") or on half the
    centers left empty ("half"): counts equal, sums bit-equal to the
    order-faithful plain version and within 1e-5 * sum|p| over each
    center's points of index_add_, two launches bit-identical."""
    rng = np.random.default_rng(bn + d + k)
    p, c = _blobs(rng, bn, d, k, cuda_device)
    cn = (c * c).sum(1)
    before = (lloyd_assign.launches, lloyd_accumulate.launches)
    labels, mind = lloyd_assign(p, c, cn)
    want_l, want_m = lloyd_assign_ref(p, c, cn)
    torch.cuda.synchronize()
    assert lloyd_assign.launches == before[0] + 1
    assert labels.dtype == torch.int32 and mind.dtype == torch.float32
    assert _near_tie(p, c, labels, want_l)
    scale = (p.double() ** 2).sum(1) + float((c.double() ** 2).sum(1).max())
    assert bool(((mind - want_m).double().abs() <= 1e-5 * scale).all())
    if skew == "one":
        labels = torch.full_like(labels, k // 3)
    elif skew == "half":
        labels = torch.from_numpy(2 * rng.integers(0, k // 2, bn).astype(
            np.int32)).to(cuda_device)
    sums0 = torch.from_numpy(rng.standard_normal((k, d)).astype(
        np.float32)).to(cuda_device)
    counts0 = torch.from_numpy(rng.integers(0, 5, k).astype(np.int32)
                               ).to(cuda_device)
    got = [(sums0.clone(), counts0.clone()) for _ in range(2)]
    for s, n_ in got:
        lloyd_accumulate(p, labels, s, n_)
    want_s, want_n = sums0.clone(), counts0.clone()
    lloyd_accumulate_ref(p, labels, want_s, want_n)
    ord_s, ord_n = sums0.clone(), counts0.clone()
    lloyd_accumulate_ordered_ref(p, labels, ord_s, ord_n)
    torch.cuda.synchronize()
    assert lloyd_accumulate.launches == before[1] + 2
    assert torch.equal(got[0][0], got[1][0]), "not deterministic"
    assert torch.equal(got[0][1], want_n) and torch.equal(ord_n, want_n)
    assert torch.equal(got[0][0], ord_s), "not the kernel's order"
    abs_sum = torch.zeros((k, d), dtype=torch.float64, device=cuda_device)
    abs_sum.index_add_(0, labels.long(), p.double().abs())
    err = (got[0][0].double() - want_s.double()).abs()
    assert bool((err <= 1e-5 * abs_sum + 1e-6 * sums0.double().abs()).all())


@pytest.mark.parametrize("bn,d,k,where", [(1000, 33, 7, None),
                                          (4099, 130, 1000, None),
                                          (2048, 128, 256, "points"),
                                          (300, 64, 257, "centers"),
                                          (131, 3, 513, None)])
def test_lloyd_assign_matches_its_tf32x3_emulation(cuda_device, bn, d, k,
                                                   where):
    """lloyd_assign (3xTF32 on the tensor cores) against its plain 3xTF32
    emulation, with d not a multiple of 4 (the split pass's zero-padded
    K-major copy), k not a multiple of the 256-center tile, and the points'
    or the centers' base 4 bytes off 16 (also copied): labels equal but at
    near-ties, mind within 1e-5 * (|p|^2 + max|c|^2), two launches
    bit-identical."""
    rng = np.random.default_rng(bn + d + k + 3)
    p, c = _blobs(rng, bn, d, k, cuda_device)
    if where == "points":
        p = _misaligned(p)
    elif where == "centers":
        c = _misaligned(c)
    cn = (c * c).sum(1)
    labels, mind = lloyd_assign(p, c, cn)
    again = lloyd_assign(p, c, cn)
    want_l, want_m = lloyd_assign_tf32x3_ref(p, c, cn)
    torch.cuda.synchronize()
    assert torch.equal(labels, again[0]) and torch.equal(mind, again[1])
    assert _near_tie(p, c, labels, want_l)
    scale = (p.double() ** 2).sum(1) + float((c.double() ** 2).sum(1).max())
    assert bool(((mind - want_m).double().abs() <= 1e-5 * scale).all())


def test_lloyd_accumulate_scratch_is_sized_by_the_library(cuda_device):
    """The int32 scratch the accumulate needs: the sorted indices, a count
    a (center, chunk of 1024 labels) and two k-vectors; a launch given less
    is refused (cudaErrorInvalidValue) before it touches anything."""
    lib = build()
    size = lib.bof_lloyd_accumulate_scratch_ints
    assert size(1, 5) == 1 + 5 + 10
    assert size(1024, 3) == 1024 + 3 + 6
    assert size(1025, 3) == 1025 + 6 + 6
    assert size(131072, 1024) == 131072 + 1024 * 128 + 2048
    p = torch.ones((3000, 4), device=cuda_device)
    labels = torch.zeros(3000, dtype=torch.int32, device=cuda_device)
    sums = torch.zeros((7, 4), device=cuda_device)
    counts = torch.zeros(7, dtype=torch.int32, device=cuda_device)
    n = size(3000, 7)
    scratch = torch.empty(n, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.bof_lloyd_accumulate(
        p.data_ptr(), labels.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), n - 1, 3000, 7, 4, stream)
    assert rc == 1  # cudaErrorInvalidValue
    assert int(counts.abs().sum()) == 0 and float(sums.abs().sum()) == 0.0
    rc = lib.bof_lloyd_accumulate(
        p.data_ptr(), labels.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), n, 3000, 7, 4, stream)
    torch.cuda.synchronize()
    assert rc == 0 and counts.tolist() == [3000, 0, 0, 0, 0, 0, 0]
    assert bool((sums[0] == 3000.0).all())


def test_lloyd_assign_ties_take_the_first_index(cuda_device):
    """Duplicated centers give bit-equal distances: the kernel, like
    jnp.argmin and torch.min, labels a point with the first of them, also
    when the duplicates lie in different 256-center tiles."""
    rng = np.random.default_rng(5)
    d, k = 24, 300
    c = rng.standard_normal((k, d)).astype(np.float32)
    for dup, src in ((3, 1), (170, 2), (299, 0), (129, 128)):
        c[dup] = c[src]
    c = torch.from_numpy(c).to(cuda_device)
    p = c[[1, 2, 0, 128, 3, 170, 299, 129]].clone()
    labels, _ = lloyd_assign(p, c, (c * c).sum(1))
    want, _ = lloyd_assign_ref(p, c, (c * c).sum(1))
    torch.cuda.synchronize()
    assert labels.tolist() == [1, 2, 0, 128, 1, 2, 0, 128]
    assert torch.equal(labels, want)


def test_lloyds_iter_on_card_matches_cpu(cuda_device, tmp_path):
    """One Lloyd pass over a flash file on the card (B7 on every block)
    against the same pass on the CPU: the same labels, centers within
    1e-5 relative, the same counts."""
    rng = np.random.default_rng(12)
    n, d, k = 5000, 16, 9
    p, c = _blobs(rng, n, d, k, "cpu")
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(tmp_path / device)))
        try:
            P = bof_tpu_torch.mem_array((n, d), np.float32, data=p.numpy(),
                                        ctx=ctx)
            L = bof_tpu_torch.mem_array((n,), np.int32, ctx=ctx)
            before = lloyd_assign.launches
            cen, inertia, counts = bof_tpu_torch.lloyds_iter(
                P, c.numpy(), labels_out=L, blk_rows=1024, ctx=ctx)
            out[device] = (cen, inertia, counts, L.read_all(),
                           lloyd_assign.launches - before)
        finally:
            ctx.destroy()
    assert out["cuda"][4] == 5 and out["cpu"][4] == 0
    np.testing.assert_array_equal(out["cuda"][3], out["cpu"][3])
    np.testing.assert_array_equal(out["cuda"][2], out["cpu"][2])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5)


def _topk_rows(rng, rows, cols, lb, case):
    s = rng.standard_normal((rows, cols), dtype=np.float32)
    mask = np.zeros(cols, np.float32)
    mask[lb:] = -np.inf
    if case == "ties":
        s = np.round(s * 2) / 2
    elif case == "all_equal":
        s[:] = 0.25
    elif case == "non_finite":
        s[0, 3], s[1, 7], s[2, :4] = np.nan, -np.nan, np.inf
        s[3, 5], s[4, :3] = -np.inf, [0.0, -0.0, 0.0]
        s[5, :] = -0.0
    return s, mask


@pytest.mark.parametrize("rows,cols,lb,k,case", [
    (512, 1024, 1024, 5, "random"),       # the fused step's band
    (512, 1024, 1024, 1, "random"),
    (64, 1024, 1000, 1024, "ties"),       # k = lb_max
    (300, 1024, 1024, 7, "all_equal"),
    (200, 1024, 40, 64, "random"),        # -inf tail wider than the labels
    (40, 8192, 8192, 5, "random"),        # past shared memory: 'l2'
    (16, 8192, 5000, 300, "ties"),
    (33, 77, 77, 9, "non_finite"),
    (7, 5000, 4096, 4096, "random"),
    (2048, 1024, 1024, 5, "random"),      # X1's band
    (512, 1022, 1000, 5, "ties"),         # cols % 4: the register body's
    (100, 1023, 1023, 64, "random"),      #   4-byte loads
    (9, 1024, 1024, 1024, "all_equal"),   # k = cols on the register body
    (45, 1024, 700, 40, "non_finite"),
    (5, 4096, 4096, 5, "random"),         # 'smem' past the register body
    (3, 1, 1, 1, "random")])
def test_row_topk_kernel_matches_plain(cuda_device, rows, cols, lb, k, case):
    """B8 against its plain version on the card: values and columns bit
    for bit (the order is a total one, so there is one right answer), on
    each of its bodies ('reg' up to 1024 columns, 'smem', 'l2')."""
    rng = np.random.default_rng(rows + cols + k)
    s, mask = _topk_rows(rng, rows, cols, lb, case)
    s_d = torch.from_numpy(s).to(cuda_device)
    m_d = torch.from_numpy(mask).to(cuda_device)
    before = dict(row_topk.variant_launches)
    got_v, got_i = row_topk(s_d, m_d, k)
    want_v, want_i = row_topk_ref(s_d, m_d, k)
    torch.cuda.synchronize()
    variant = topk_variant(cols)
    assert row_topk.variant_launches[variant] == before[variant] + 1
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("k", [5, 1024])
def test_row_topk_register_body_takes_an_unaligned_row_base(cuda_device, k):
    """Rows that start off a 16-byte boundary (a view one float into a
    buffer) take the register body's 4-byte loads: the same bits."""
    rng = np.random.default_rng(k)
    s, mask = _topk_rows(rng, 300, 1024, 1000, "ties")
    flat = torch.empty(300 * 1024 + 1, device=cuda_device)
    s_d = flat[1:].view(300, 1024)
    s_d.copy_(torch.from_numpy(s))
    m_d = torch.from_numpy(mask).to(cuda_device)
    got_v, got_i = row_topk(s_d, m_d, k)
    want_v, want_i = row_topk_ref(s_d, m_d, k)
    torch.cuda.synchronize()
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


def _b10_input(rng, n, dtype):
    """Seeded elements with duplicates and, for floats, +-0.0, +-inf and
    NaNs of both signs with payloads."""
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.random(n) > 0.5
    if dt.kind in "iu":
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        x[: n // 2] = x[rng.integers(0, 64, n // 2)]  # duplicates
        return x
    x = np.round(rng.standard_normal(n), 2).astype(dt)
    ub = np.uint32 if dt.itemsize == 4 else np.uint16
    specials = ([0x80000000, 0, 0x7F800000, 0xFF800000, 0x7FC00000,
                 0xFFC00000, 0x7FC00123, 0xFF800001] if dt.itemsize == 4 else
                [0x8000, 0, 0x7C00, 0xFC00, 0x7E00, 0xFE00, 0x7E12, 0xFC01])
    at = rng.choice(n, n // 8, replace=False)
    x.view(ub)[at] = np.array(specials, ub)[rng.integers(0, 8, len(at))]
    return x


def _b10_same_bits_each_time(t, dtype):
    """B10 twice on the card tensor t: both give sort_block_ref's bits, the
    input is not written, one launch a call, and the keys come out
    non-decreasing."""
    keep = t.clone()
    before = sort_block.launches
    got = sort_block(t, dtype)
    again = sort_block(t, dtype)
    want = sort_block_ref(t, dtype)
    torch.cuda.synchronize()
    assert sort_block.launches == before + 2
    assert torch.equal(got, want) and torch.equal(again, want)
    assert torch.equal(t, keep)
    keys = canonical_keys(got, dtype)
    assert bool((keys[1:] >= keys[:-1]).all())


# B10's tile (csrc/sort.cu; tests/test_torch_sort_map.py holds it to the
# source): one element, a tile's edges, 2^18 + 1 (35 tiles, the last
# ragged, so a look-back walks over many) and a ragged length
@pytest.mark.parametrize("n", [1, SORT_TILE - 1, SORT_TILE, SORT_TILE + 1,
                               (1 << 18) + 1, 1_000_003])
@pytest.mark.parametrize("dtype", sorted(SORT_KINDS, key=str))
def test_sort_block_kernel_matches_plain(cuda_device, dtype, n):
    """B10 against its plain version on the card, bit for bit, for each
    element type, on tiles' edges and ragged lengths; two launches give
    the same bits, and the input is not written."""
    rng = np.random.default_rng(n)
    x = _b10_input(rng, n, dtype)
    _b10_same_bits_each_time(bits_of(x).to(cuda_device), dtype)


def _b10_skewed(case, n, dtype, rng):
    """n elements of numpy dtype `dtype` in one of B10's skewed or ordered
    cases: all equal, +-0.0 alternating (floats), already sorted and
    reverse sorted (in B10's order), two values alternating, all NaNs of
    both signs with payloads (floats)."""
    dt = np.dtype(dtype)
    if case == "all_equal":
        return np.full(n, True if dt == np.bool_ else (
            1.5 if dt.kind == "f" else (-3 if dt.kind == "i" else 200)), dt)
    if case == "zeros_alternating":
        x = np.zeros(n, dt)
        x[::2] = -0.0
        return x
    if case == "two_alternating":
        a, b = ((True, False) if dt == np.bool_ else (2.5, -1.0)
                if dt.kind == "f" else (5, -7) if dt.kind == "i" else
                (250, 5))
        x = np.full(n, a, dt)
        x[1::2] = b
        return x
    if case == "all_nans":
        ub, sign, exp, mant = ((np.uint32, 1 << 31, 0x7F800000, 0x7FFFFF)
                               if dt.itemsize == 4 else
                               (np.uint16, 1 << 15, 0x7C00, 0x3FF))
        payload = rng.integers(1, mant + 1, n).astype(ub)
        signs = (rng.random(n) < 0.5).astype(ub) * ub(sign)
        return (signs | ub(exp) | payload).view(dt)
    x = _b10_input(rng, n, dtype)
    order = torch.sort(canonical_keys(bits_of(x), dt), stable=True).indices
    x = x[order.numpy()]
    return x if case == "sorted" else x[::-1].copy()


B10_SKEWED = [(dt, case) for dt in sorted(SORT_KINDS, key=str)
              for case in ("all_equal", "zeros_alternating", "sorted",
                           "reverse", "two_alternating", "all_nans")
              if dt.kind == "f" or case not in ("zeros_alternating",
                                                "all_nans")]


@pytest.mark.parametrize("dtype,case", B10_SKEWED)
def test_sort_block_kernel_on_skewed_and_ordered_inputs(cuda_device, dtype,
                                                        case):
    """B10 bit for bit against its plain version where one digit holds a
    whole tile or every tile (all equal; +-0.0 alternating, where only
    stability decides the bits; all NaNs, which share one key), where the
    input is already in order or in reverse, and where two values
    alternate; twice, the input unwritten, the keys non-decreasing."""
    rng = np.random.default_rng(len(case))
    x = _b10_skewed(case, 1_000_003, dtype, rng)
    _b10_same_bits_each_time(bits_of(x).to(cuda_device), dtype)


def test_row_topk_masked_negative_nan_comes_back_canonical(cuda_device):
    """A deliberate difference from lax.top_k on the CPU (ROADMAP C): the
    card's fp32 add returns the canonical NaN (bits 0x7FFFFFFF), so under
    a mask a -NaN score comes back +NaN and ranks first, where the CPU
    keeps -NaN and ranks it last (test_torch_apps.py's non_finite case).
    Without a mask nothing is added: the kernel keeps the score's own
    bits and ranks -NaN last, as the CPU does."""
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    s = np.arange(16, dtype=np.float32)[None, :].copy()
    s[0, 7] = neg_nan
    s_d = torch.from_numpy(s).to(cuda_device)
    m_d = torch.zeros(16, device=cuda_device)
    v, i = row_topk(s_d, m_d, 16)
    want_v, want_i = row_topk_ref(s_d, m_d, 16)
    assert torch.equal(v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(i, want_i)
    bits = v.view(torch.int32).cpu().numpy().view(np.uint32)
    assert bits[0, 0] == 0x7FFFFFFF and int(i[0, 0]) == 7
    v, i = row_topk(s_d, None, 16)
    bits = v.view(torch.int32).cpu().numpy().view(np.uint32)
    assert bits[0, 15] == 0xFFC00000 and int(i[0, 15]) == 7
    assert i[0, :15].tolist() == list(range(15, 7, -1)) + list(range(6, -1,
                                                                     -1))


def test_xml_rank_on_card_matches_cpu(cuda_device, tmp_path):
    """The fused XML path on the card (K2 + B8 a band) against the same
    call on the CPU: scores within 2e-4, labels equal where the scores
    stand apart, one K2 and one B8 launch a band."""
    import scipy.sparse as sps
    rng = np.random.default_rng(21)
    docs, vocab, n_labels, k = 900, 300, 70, 6
    a_sp = sps.random(docs, vocab, density=0.05, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(2))
    w = rng.standard_normal((n_labels, vocab), dtype=np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(tmp_path / device),
            max_nnzs=4096))
        try:
            A = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
            W = bof_tpu_torch.mem_array((n_labels, vocab), np.float32,
                                        data=w, ctx=ctx)
            before = (spmm_ell.launches, row_topk.launches)
            s, l = bof_tpu_torch.xml_rank(A, W, k, label_blk=32,
                                          fused=True, ctx=ctx)
            out[device] = (s.read_all(), l.read_all(),
                           spmm_ell.launches - before[0],
                           row_topk.launches - before[1])
        finally:
            ctx.destroy()
    (gs, gl, g_k2, g_b8), (ws, wl, _, _) = out["cuda"], out["cpu"]
    assert g_k2 == g_b8 > 0
    np.testing.assert_allclose(gs, ws, rtol=2e-4, atol=1e-4)
    d = np.abs(np.diff(ws, axis=1)) > 1e-5 * np.abs(ws).max()
    apart = np.ones(ws.shape, bool)
    apart[:, 1:] &= d
    apart[:, :-1] &= d
    np.testing.assert_array_equal(gl[apart], wl[apart])


def test_xml_rank_uploads_w_panels_page_locked(cuda_device, tmp_path,
                                              monkeypatch):
    """The fused XML path with W (fp32, in a file) in a Program Cache
    that holds it, called twice: on the second call each W panel goes up
    from a page-locked source and their bytes are all that
    `h2d.locked_bytes` counts (the ELL bands and the mask are fresh
    arrays), each panel's buffer was locked once, and the scores and
    labels are byte-equal to the first call's."""
    import scipy.sparse as sps

    from bof_tpu_torch.utils import METRICS
    rng = np.random.default_rng(22)
    docs, vocab, n_labels, k, panel = 900, 3001, 200, 5, 64
    a_sp = sps.random(docs, vocab, density=0.02, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(3))
    w = rng.standard_normal((n_labels, vocab), dtype=np.float32)
    w.tofile(str(tmp_path / "W"))
    seen = _record_uploads(monkeypatch)
    ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
        device="cuda", scratch_dir=str(tmp_path / "s"), io_backend="native",
        max_nnzs=4096, program_budget=64 << 20))
    try:
        A = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        W = bof_tpu_torch.map_array(str(tmp_path / "W"), w.shape,
                                    np.float32, ctx=ctx)
        out = []
        for _ in range(2):
            seen.clear()
            locked0 = METRICS.get("h2d.locked_bytes")
            s, l = bof_tpu_torch.xml_rank(A, W, k, label_blk=panel,
                                          fused=True, ctx=ctx)
            locked = METRICS.get("h2d.locked_bytes") - locked0
            out.append((s.read_all().tobytes(), l.read_all().tobytes()))
        stats = ctx.pin_cache_stats()
    finally:
        ctx.destroy()
    panels = [min(panel, n_labels - b0) * vocab * 4
              for b0 in range(0, n_labels, panel)]
    assert locked == w.nbytes
    assert sorted(nb for nb, pinned in seen if pinned) == sorted(panels)
    assert stats["locks"] == len(panels) and stats["lock_fails"] == 0
    assert out[0] == out[1]


def test_eigensolver_on_card_matches_cpu(cuda_device, tmp_path):
    """The one-pass A^T A V operator with both halves on K2, on the card
    against the CPU (rtol 1e-4), and block Lanczos's sigmas."""
    import importlib
    import scipy.sparse as sps
    eig = importlib.import_module("bof_tpu_torch.apps.eigensolver")
    rng = np.random.default_rng(5)
    a_sp = sps.random(2000, 600, density=0.02, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(5))
    v = rng.standard_normal((600, 16))
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(tmp_path / device),
            max_nnzs=8192, hbm_budget=1 << 22))
        try:
            A = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
            before = spmm_ell.launches
            u = eig._apply_ata_one_pass_device(A, v, ctx)
            sigma, _ = eig.block_lanczos_svd(A, 6, tol=1e-9, ctx=ctx)
            out[device] = (u, sigma, spmm_ell.launches - before)
        finally:
            ctx.destroy()
    assert out["cuda"][2] > 0 and out["cpu"][2] == 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)


def test_apply_gram_on_card_sums_u_as_the_host_fold(cuda_device, tmp_path,
                                                    monkeypatch):
    """apply_gram on the card: U's float64 additions there (index_add_ of
    each column band's K2 partial) give the bits of the host fold
    `U[rows] += u` over the same partials in band order; column bands
    hold only touched words; U comes down once (vocab x b x 8 bytes)."""
    import importlib
    import scipy.sparse as sps
    from bof_tpu_torch.utils import METRICS
    eig = importlib.import_module("bof_tpu_torch.apps.eigensolver")
    a_sp = sps.random(3000, 200000, density=2e-4, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(7))
    v = np.random.default_rng(7).standard_normal((200000, 24)).astype(
        np.float32)
    seen = []
    stream = eig._one_pass_stream

    def spy(a, v_np, ctx, device, fwd, trans, finalize=None):
        def t_product(w, cband):
            rows, u = trans(w, cband)
            seen.append((cband.rows.copy(), cband.counts.copy(),
                         u.cpu().numpy()))
            return rows, u
        return stream(a, v_np, ctx, device, fwd, t_product, finalize)
    monkeypatch.setattr(eig, "_one_pass_stream", spy)
    ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
        device="cuda", scratch_dir=str(tmp_path), max_nnzs=1 << 14,
        hbm_budget=1 << 28))
    d2h = METRICS.get("eig.d2h_bytes")
    try:
        A = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        got = bof_tpu_torch.apply_gram(A, v, ctx=ctx)
    finally:
        ctx.destroy()
    host = np.zeros(v.shape, np.float64)
    for rows, counts, u in seen:
        assert (counts > 0).all()
        host[rows] += u
    assert len(seen) > 1
    assert got.tobytes() == host.tobytes()
    assert METRICS.get("eig.d2h_bytes") - d2h == got.nbytes
    want = a_sp.T.astype(np.float64) @ (a_sp.astype(np.float64) @ v)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def test_topic_model_on_card_matches_cpu(cuda_device, tmp_path):
    """topic_model through K2 (projection) and B7 (clustering) on the card
    against the CPU: labels equal, topic-word matrices within 1e-4."""
    import scipy.sparse as sps
    rows, cols = [], []
    rs = np.random.RandomState(3)
    for t in range(4):
        for d in range(150):
            for word in t * 40 + rs.randint(0, 40, 15):
                rows.append(t * 150 + d)
                cols.append(word)
    a_sp = sps.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                          shape=(600, 160))
    a_sp.sum_duplicates()
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(tmp_path / device)))
        try:
            A = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
            before = (spmm_ell.launches, lloyd_assign.launches)
            tw, labels = bof_tpu_torch.topic_model(A, 4, proj_dim=16,
                                                   n_iters=5,
                                                   sample_rate=0.5, ctx=ctx)
            out[device] = (tw, labels, spmm_ell.launches - before[0],
                           lloyd_assign.launches - before[1])
        finally:
            ctx.destroy()
    assert min(out["cuda"][2:]) > 0 and max(out["cpu"][2:]) == 0
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-6)


def test_sort_and_map_on_card_match_cpu(cuda_device, tmp_path):
    """The out-of-core sort with sort_compute='device' (B10 on every phase-1
    block and phase-3 bucket) gives the CPU's bits, with -0.0/+0.0 and
    signed NaNs in it; bof_map's torch.sqrt on the card is np.sqrt bit for
    bit (correctly rounded there), and a 64-bit map stays on the host."""
    rng = np.random.default_rng(31)
    x = _b10_input(rng, 200_003, np.float32)
    pos = np.abs(rng.standard_normal(100_001)).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device=device, scratch_dir=str(tmp_path / device),
            sort_compute="device"))
        try:
            src = bof_tpu_torch.mem_array(x.shape, x.dtype, data=x.copy(),
                                          ctx=ctx)
            dst = bof_tpu_torch.mem_array(x.shape, x.dtype, ctx=ctx)
            before = sort_block.launches
            bof_tpu_torch.bof_sort(src, dst, blk_elems=30_000, ctx=ctx)
            launches = sort_block.launches - before
            ps = bof_tpu_torch.mem_array(pos.shape, pos.dtype, data=pos,
                                         ctx=ctx)
            pd = bof_tpu_torch.mem_array(pos.shape, pos.dtype, ctx=ctx)
            bof_tpu_torch.bof_map(ps, pd, torch.sqrt, blk_elems=30_000,
                                  ctx=ctx)
            out[device] = (dst.read_all(), pd.read_all(), launches)
        finally:
            ctx.destroy()
    assert out["cpu"][2] == 0 and out["cuda"][2] >= 7  # 7 blocks + buckets
    np.testing.assert_array_equal(out["cuda"][0].view(np.uint32),
                                  out["cpu"][0].view(np.uint32))
    np.testing.assert_array_equal(out["cuda"][1].view(np.uint32),
                                  np.sqrt(pos).view(np.uint32))
