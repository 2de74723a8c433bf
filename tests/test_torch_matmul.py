"""Kernel K1 (bof_tpu_torch/ops/matmul_cuda.py) and the port's device
step, held against bof_tpu's Pallas MXU kernel (interpret mode) and its
XLA accumulate step on the same numpy inputs.

fp32 tolerance rtol 2e-4 (accumulation order differs between XLA, the
Pallas interpreter and torch; the repo's invariant).  The kernel itself
runs only on a CUDA card: tests/test_torch_cuda.py holds it against this
plain version there.
"""
import itertools

import ml_dtypes
import numpy as np
import pytest
import torch

from bof_tpu.ops import device as ref_device
from bof_tpu.ops.matmul_pallas import matmul as pallas_matmul
from bof_tpu_torch.ops import device as port_device
from bof_tpu_torch.io.native import cast_bf16, quantize_i8
from bof_tpu_torch.ops.matmul_cuda import (K1_PASSES, K1_S8_MAX_K,
                                           K1_VARIANTS, accum_matmul,
                                           accum_matmul_ref,
                                           accum_matmul_tf32_ref, k1_ldw,
                                           k1_packs, k1_variant,
                                           k1_workspace, pack_kmajor_ref,
                                           reset_launch_counts,
                                           tf32_ldw, tf32_truncate)

LAYOUTS = list(itertools.product([False, True], repeat=3))


def _storage(rng, m, n, k, a_km, b_nk, c_nm):
    """Storage-major operands of one logical problem (numpy, fp32)."""
    a_log = rng.standard_normal((m, k)).astype(np.float32)
    b_log = rng.standard_normal((k, n)).astype(np.float32)
    c_log = rng.standard_normal((m, n)).astype(np.float32)
    a = np.ascontiguousarray(a_log.T) if a_km else a_log
    b = np.ascontiguousarray(b_log.T) if b_nk else b_log
    c = np.ascontiguousarray(c_log.T) if c_nm else c_log
    return a, b, c


@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_plain_version_matches_pallas_interpret(rng, a_km, b_nk, c_nm):
    """accum_matmul_ref on a zero C is the Pallas kernel's product, for
    every storage layout (tests/test_pallas.py's shapes and tiles)."""
    m, n, k = 256, 128, 128
    a, b, _ = _storage(rng, m, n, k, a_km, b_nk, c_nm)
    want = np.asarray(pallas_matmul(a, b, bm=128, bn=128, bk=64,
                                    a_km=a_km, b_nk=b_nk, c_nm=c_nm,
                                    interpret=True))
    c = torch.zeros((n, m) if c_nm else (m, n))
    got = accum_matmul_ref(c, torch.from_numpy(a), torch.from_numpy(b), 1.0,
                           a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_accum_step_matches_reference(rng, a_km, b_nk, c_nm):
    """The port's device.accum_step against bof_tpu's XLA accumulate
    step: alpha != 1, a non-zero C, a ragged shape, updated in place."""
    m, n, k = 40, 24, 56
    alpha = 1.75
    a, b, c = _storage(rng, m, n, k, a_km, b_nk, c_nm)
    want = np.asarray(ref_device.accum_step(
        c.copy(), a, b, np.float32(alpha), a_km=a_km, b_nk=b_nk, c_nm=c_nm,
        prec="highest", impl="xla"))
    c_t = torch.from_numpy(c.copy())
    got = port_device.accum_step(c_t, torch.from_numpy(a),
                                 torch.from_numpy(b), alpha, a_km=a_km,
                                 b_nk=b_nk, c_nm=c_nm, prec="highest")
    assert got.data_ptr() == c_t.data_ptr(), "accum_step updates C in place"
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "inner"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros(4, 6)
    b = torch.zeros(6, 5)
    c = torch.zeros(4, 5)
    if bad == "dtype":
        a, err = a.double(), TypeError
    elif bad == "shape":
        c, err = torch.zeros(5, 4), ValueError
    elif bad == "contiguity":
        a, err = torch.zeros(6, 4).T, ValueError
    else:
        b, err = torch.zeros(7, 5), ValueError
    with pytest.raises(err):
        accum_matmul(c, a, b, 1.0, a_km=False, b_nk=False, c_nm=False)


def test_scale_init_and_zeros_block():
    c = torch.ones(3, 4)
    assert port_device.scale_init(c, 2.5) is c
    assert float(c.sum()) == 30.0
    z = port_device.zeros_block((2, 3), torch.device("cpu"))
    assert z.dtype == torch.float32 and not z.any()


@pytest.mark.parametrize("prec", ["high", "default"])
@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_accum_step_every_precision_matches_reference(rng, prec, a_km, b_nk,
                                                      c_nm):
    """The other precisions on the CPU: the plain version is full fp32 at
    every prec, as bof_tpu's XLA step is on a CPU."""
    m, n, k = 40, 24, 56
    a, b, c = _storage(rng, m, n, k, a_km, b_nk, c_nm)
    want = np.asarray(ref_device.accum_step(
        c.copy(), a, b, np.float32(-0.5), a_km=a_km, b_nk=b_nk, c_nm=c_nm,
        prec=prec, impl="xla"))
    got = port_device.accum_step(torch.from_numpy(c.copy()),
                                 torch.from_numpy(a), torch.from_numpy(b),
                                 -0.5, a_km=a_km, b_nk=b_nk, c_nm=c_nm,
                                 prec=prec)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-4)


def test_precision_maps_to_tensor_core_passes():
    """3xTF32 (about 21 bits kept) for the tiers the TPU runs as 3 or 6
    bf16 passes; one TF32 pass (11 bits) for its one bf16 pass (8)."""
    assert K1_PASSES == {"highest": 3, "high": 3, "default": 1}


@pytest.mark.parametrize("lda,ldb,aligned,prec,want,packs", [
    (8192, 8192, True, "highest", "tf32x3", (False, False)),
    (8192, 8192, True, "high", "tf32x3", (False, False)),
    (8192, 8192, True, "default", "tf32", (False, False)),
    (516, 776, True, "highest", "tf32x3", (False, False)),
    (1000, 516, True, "default", "tf32", (False, False)),
    # chip_smoke's ragged shape: TMA cannot read either operand in place
    (513, 777, True, "highest", "tf32x3", (True, True)),
    (513, 777, True, "default", "tf32", (True, True)),
    (516, 514, True, "highest", "tf32x3", (False, True)),  # 8-byte rows
    (6, 8, True, "default", "tf32", (True, False)),
    # a base not 16-byte aligned
    (8192, 8192, False, "highest", "tf32x3", (True, True)),
])
def test_k1_variant_rule(lda, ldb, aligned, prec, want, packs):
    """Every fp32 operand runs on the tensor cores, at its tier's pass
    count; an operand TMA cannot read where it lies (rows not a multiple
    of 16 bytes apart, a base not 16-byte aligned) is one the split pass
    rewrites K-major first (here both stored K-major: A (M,K), B (N,K))."""
    assert k1_variant(prec) == want
    assert k1_packs(False, True, lda, ldb, torch.float32,
                    (aligned, aligned)) == packs


@pytest.mark.parametrize("call", ["variant", "wrapper", "accum_step"])
def test_unknown_precision_raises(call):
    a, b, c = torch.zeros(4, 8), torch.zeros(8, 4), torch.zeros(4, 4)
    with pytest.raises(ValueError, match="precision"):
        if call == "variant":
            k1_variant("fastest")
        elif call == "wrapper":
            accum_matmul(c, a, b, 1.0, a_km=False, b_nk=False, c_nm=False,
                         prec="fastest")
        else:
            port_device.accum_step(c, a, b, 1.0, a_km=False, b_nk=False,
                                   c_nm=False, prec="bfloat16")


@pytest.mark.parametrize("a_km,b_nk,passes", list(itertools.product(
    [False, True], [False, True], [1, 3])))
def test_k1_workspace(a_km, b_nk, passes):
    """Operands whose rows and bases TMA can read: a K-major copy only of
    an operand whose storage is not K-major, lo parts only for 3 passes;
    rows of k rounded up to 128 bytes (32 floats)."""
    rows = k1_workspace(1000, 776, 513, a_km=a_km, b_nk=b_nk, passes=passes,
                        lda=1000 if a_km else 516, ldb=516 if b_nk else 776,
                        aligned=(True, True))
    want = {}
    if a_km:
        want["a_x"] = 1000
    if not b_nk:
        want["b_x"] = 776
    if passes == 3:
        want.update(a_lo=1000, b_lo=776)
    assert rows == want
    assert (tf32_ldw(513), tf32_ldw(516), tf32_ldw(1)) == (544, 544, 32)


@pytest.mark.parametrize("lda,ldb,aligned,want_x", [
    (513, 513, (True, True), {"a_x": 1000, "b_x": 776}),  # odd rows
    (514, 516, (True, True), {"a_x": 1000}),              # 8-byte rows
    (516, 516, (False, True), {"a_x": 1000}),              # A's base
    (516, 516, (True, False), {"b_x": 776}),               # B's base
    (516, 516, (True, True), {}),
])
@pytest.mark.parametrize("passes", [1, 3])
def test_k1_workspace_rewrites_what_tma_cannot_read(lda, ldb, aligned,
                                                    want_x, passes):
    """Both operands stored K-major (A (M,K), B (N,K)): the split pass
    copies one K-major only where TMA cannot read it, a leading dimension
    that is not a multiple of 4 floats or a base that is not 16-byte
    aligned (`k1_packs`' rule in fp32); the lo parts as before."""
    rows = k1_workspace(1000, 776, 513, a_km=False, b_nk=True,
                        passes=passes, lda=lda, ldb=ldb, aligned=aligned)
    assert [tf32_ldw(k) for k in (513, 8193, 8192, 1)] == [544, 8224,
                                                          8192, 32]
    want = dict(want_x)
    if passes == 3:
        want.update(a_lo=1000, b_lo=776)
    assert rows == want
    # an MN-major operand is copied whatever its rows and base
    rows = k1_workspace(1000, 776, 513, a_km=True, b_nk=False,
                        passes=passes, lda=lda, ldb=ldb, aligned=aligned)
    assert rows["a_x"] == 1000 and rows["b_x"] == 776


def test_tf32_truncation_and_one_pass_emulation(rng):
    """tf32_truncate keeps sign, exponent and 10 mantissa bits; the
    one-pass emulation is the plain version on truncated operands, and
    exact where the operands are TF32 already."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, -3.0000002,
                      0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, -3.0, 0.0])
    assert torch.equal(tf32_truncate(x), want)
    a, b, c = _storage(rng, 24, 16, 40, False, True, True)
    a_t, b_t = (torch.from_numpy(v) for v in (a, b))
    got = accum_matmul_tf32_ref(torch.from_numpy(c.copy()), a_t, b_t, 1.5,
                                a_km=False, b_nk=True, c_nm=True)
    want = accum_matmul_ref(torch.from_numpy(c.copy()), tf32_truncate(a_t),
                            tf32_truncate(b_t), 1.5, a_km=False, b_nk=True,
                            c_nm=True)
    assert torch.equal(got, want)
    lo = a_t - tf32_truncate(a_t)
    assert float(lo.abs().max()) <= 2.0 ** -10 * float(a_t.abs().max())
    assert torch.equal(tf32_truncate(tf32_truncate(a_t)), tf32_truncate(a_t))


def _lowp_storage(rng, m, n, k, a_km, b_nk, c_nm, kind):
    """Storage-major A/B in a transfer mode's type, as the gemm producer
    makes them, for both packages: bf16 (the port's tensor, bof_tpu's
    ml_dtypes array; then the fp32 A/B they were rounded from) or int8
    (then the two tile scales); and an fp32 C."""
    a, b, c = _storage(rng, m, n, k, a_km, b_nk, c_nm)
    if kind == "bf16":
        bits = [cast_bf16(x) for x in (a, b)]
        port = [torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
                for x in bits]
        ref = [x.view(ml_dtypes.bfloat16) for x in bits]
        return port, ref, (a, b), c
    q = [quantize_i8(x) for x in (a, b)]
    return ([torch.from_numpy(x) for x, _ in q], [x for x, _ in q],
            (q[0][1], q[1][1]), c)


@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_bf16_plain_matches_reference_accum_step(rng, a_km, b_nk, c_nm):
    """K1 'bf16''s plain version (the port's accum_step on bf16 tiles)
    against bof_tpu's XLA step on the same bf16 tiles (fp32 accumulator),
    alpha != 1, a non-zero C, in place."""
    m, n, k = 40, 24, 56
    (a, b), (ra, rb), fp32, c = _lowp_storage(rng, m, n, k, a_km, b_nk,
                                              c_nm, "bf16")
    want = np.asarray(ref_device.accum_step(
        c.copy(), ra, rb, np.float32(1.75), a_km=a_km, b_nk=b_nk, c_nm=c_nm,
        prec="highest", impl="xla"))
    c_t = torch.from_numpy(c.copy())
    got = port_device.accum_step(c_t, a, b, 1.75, a_km=a_km, b_nk=b_nk,
                                 c_nm=c_nm, prec="default")
    assert got.data_ptr() == c_t.data_ptr()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-4)
    # it really ran on rounded operands: the fp32 ones give another answer
    unrounded = accum_matmul_ref(torch.from_numpy(c.copy()),
                                 *map(torch.from_numpy, fp32), 1.75,
                                 a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    assert not np.allclose(got.numpy(), unrounded.numpy(), rtol=1e-3)


@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_bf16_plain_matches_pallas_interpret(rng, a_km, b_nk, c_nm):
    """bof_tpu's Pallas K1 on bf16 tiles with out_dtype fp32 (what its
    accum_step runs on a TPU) against the plain 'bf16' version."""
    m, n, k = 256, 128, 128
    (a, b), (ra, rb), _, _ = _lowp_storage(rng, m, n, k, a_km, b_nk, c_nm,
                                           "bf16")
    want = np.asarray(pallas_matmul(ra, rb, bm=128, bn=128, bk=64,
                                    out_dtype=np.float32, a_km=a_km,
                                    b_nk=b_nk, c_nm=c_nm, interpret=True))
    c = torch.zeros((n, m) if c_nm else (m, n))
    got = accum_matmul(c, a, b, 1.0, a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("a_km,b_nk,c_nm", LAYOUTS)
def test_s8_plain_matches_reference_accum_step_q(rng, a_km, b_nk, c_nm):
    """K1 's8''s plain version (the port's accum_step_q) against bof_tpu's:
    int8 tiles with their scales, scale = alpha * s_a * s_b as gemm
    computes it, a non-zero C."""
    m, n, k = 40, 24, 56
    (a, b), (ra, rb), (sa, sb), c = _lowp_storage(rng, m, n, k, a_km, b_nk,
                                                  c_nm, "s8")
    scale = np.float32(0.75 * sa * sb)
    want = np.asarray(ref_device.accum_step_q(
        c.copy(), ra, rb, scale, a_km=a_km, b_nk=b_nk, c_nm=c_nm))
    c_t = torch.from_numpy(c.copy())
    got = port_device.accum_step_q(c_t, a, b, float(scale), a_km=a_km,
                                   b_nk=b_nk, c_nm=c_nm)
    assert got.data_ptr() == c_t.data_ptr()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    # the plain version's arithmetic, written out: an exact integer
    # product, to fp32, times the scale, plus C, each rounded in fp32
    lhs = (ra.T if a_km else ra).astype(np.int64)
    rhs = (rb.T if b_nk else rb).astype(np.int64)
    exact = (lhs @ rhs).astype(np.float32) * scale
    np.testing.assert_array_equal(got.numpy(),
                                  c + (exact.T if c_nm else exact))


def test_s8_refuses_a_k_whose_int32_sum_could_overflow():
    """2^17, the power of two below 2^31 / 127^2 (133,143)."""
    k = K1_S8_MAX_K + 1
    assert 127 ** 2 * K1_S8_MAX_K < 2 ** 31 <= 127 ** 2 * 2 * K1_S8_MAX_K
    a = torch.zeros((1, k), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        accum_matmul(torch.zeros(1, 1), a, a.T.contiguous(), 1.0,
                     a_km=False, b_nk=False, c_nm=False)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "bf16"),
                                        (torch.int8, "s8"),
                                        (torch.float32, "tf32x3")])
@pytest.mark.parametrize("prec", ["highest", "default"])
def test_k1_variant_by_operand_type(dtype, want, prec):
    """Each operand type picks its variant at any leading dimension (the
    pass before the product rewrites what TMA cannot read in place, and
    here `k1_packs` names both operands); the transfer modes' at every
    precision, fp32's by the tier's pass count ('default': one pass)."""
    if dtype == torch.float32 and prec == "default":
        want = "tf32"
    assert k1_variant(prec, dtype=dtype) == want
    assert k1_packs(False, True, 513, 777, dtype) == (True, True)
    assert "bf16" in K1_VARIANTS and "s8" in K1_VARIANTS


def test_mixed_operand_types_raise():
    with pytest.raises(TypeError):
        accum_matmul(torch.zeros(2, 2), torch.zeros(2, 2, dtype=torch.int8),
                     torch.zeros(2, 2, dtype=torch.bfloat16), 1.0,
                     a_km=False, b_nk=False, c_nm=False)


@pytest.mark.parametrize("ld_extra", [0, 11])
@pytest.mark.parametrize("mn_major", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_pack_kmajor_ref_is_a_transpose_and_pad(rng, dtype, mn_major,
                                                ld_extra):
    """The pack pass's plain version against numpy: the K-major copy of
    the stored operand, rows ld apart, zero past K; bit for bit."""
    rows, k = 19, 37
    shape = (k, rows) if mn_major else (rows, k)
    if dtype == torch.int8:
        bits = rng.integers(-127, 128, shape).astype(np.int8)
        x = torch.from_numpy(bits)
    else:
        bits = cast_bf16(rng.standard_normal(shape).astype(np.float32))
        x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        bits = bits.view(np.int16)
    ld = k + ld_extra
    got = pack_kmajor_ref(x, mn_major=mn_major, ld=ld)
    want = np.zeros((rows, ld), bits.dtype)
    want[:, :k] = bits.T if mn_major else bits
    assert got.dtype == dtype and got.is_contiguous()
    got_bits = got.view(torch.int16) if dtype == torch.bfloat16 else got
    np.testing.assert_array_equal(got_bits.numpy(), want)
    with pytest.raises(ValueError):
        pack_kmajor_ref(x, mn_major=mn_major, ld=k - 1)


def test_lowp_workspace_rows_are_16_bytes():
    """The pack pass's workspace rows: K rounded up to 16 bytes."""
    assert [k1_ldw(k, 2) for k in (1, 8, 516, 1027)] == [8, 8, 520, 1032]
    assert [k1_ldw(k, 1) for k in (1, 16, 516, 8192)] == [16, 16, 528, 8192]
    assert k1_ldw(513) == k1_ldw(513, 4) == 516


@pytest.mark.parametrize("dtype,ld,rows_ok", [
    (torch.bfloat16, 8192, True), (torch.bfloat16, 1024, True),
    (torch.bfloat16, 516, False), (torch.bfloat16, 1027, False),
    (torch.int8, 8192, True), (torch.int8, 1024, True),
    (torch.int8, 516, False), (torch.int8, 1032, False)])
@pytest.mark.parametrize("a_km,b_nk", list(itertools.product([False, True],
                                                             repeat=2)))
def test_lowp_pack_rule(a_km, b_nk, dtype, ld, rows_ok):
    """Which operands the 'bf16'/'s8' wrapper packs: an MN-major one (A
    stored (K,M), B stored (K,N)), or one whose rows are not a multiple of
    16 bytes apart or whose base is not 16-byte aligned."""
    want = (a_km or not rows_ok, not b_nk or not rows_ok)
    assert k1_packs(a_km, b_nk, ld, ld, dtype) == want
    assert k1_packs(a_km, b_nk, ld, ld, dtype, (True, True)) == want
    assert k1_packs(a_km, b_nk, ld, ld, dtype,
                    aligned=(False, True)) == (True, want[1])
    assert k1_packs(a_km, b_nk, ld, ld, dtype,
                    aligned=(True, False)) == (want[0], True)
    assert k1_packs(a_km, b_nk, ld, ld, dtype,
                    aligned=(False, False)) == (True, True)


def test_lowp_pack_rule_on_the_main_paths():
    """S6 (int8, R/N/N at blk 8192: A (M,K), B (K,N)) packs B alone; S7
    (bf16, C/T/N: a_km False, b_nk True) packs nothing."""
    assert k1_packs(False, False, 8192, 8192, torch.int8) == (False, True)
    assert k1_packs(False, True, 8192, 8192, torch.bfloat16) == (False,
                                                                 False)


def test_lowp_pack_count_is_reset_and_left_alone_on_the_cpu(rng):
    """reset_launch_counts zeroes the pack counts; the CPU path (the plain
    versions) packs nothing and launches nothing."""
    accum_matmul.lowp_packs = 5
    accum_matmul.tf32_packs = 3
    reset_launch_counts()
    assert accum_matmul.lowp_packs == 0 and accum_matmul.launches == 0
    assert accum_matmul.tf32_packs == 0
    a = torch.zeros((8, 6), dtype=torch.int8)
    accum_matmul(torch.zeros(6, 5), a, torch.zeros((8, 5), dtype=torch.int8),
                 1.0, a_km=True, b_nk=False, c_nm=False)
    accum_matmul(torch.zeros(6, 5), torch.zeros((8, 6)), torch.zeros((8, 5)),
                 1.0, a_km=True, b_nk=False, c_nm=False)
    assert accum_matmul.lowp_packs == 0 and accum_matmul.launches == 0
    assert accum_matmul.tf32_packs == 0


def test_lowp_variant_tool_edits_apply_to_the_committed_kernel():
    """tools/torch_k1_lowp_variants.py times textual variants of
    csrc/matmul_lowp.cu (the measurements PERF.md cites): each edit must
    still find its text in the committed source, once."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "k1_lowp_variants",
        os.path.join(root, "tools", "torch_k1_lowp_variants.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(tool.CSRC, "matmul_lowp.cu")) as f:
        src = f.read()
    variants = tool._variants(src)
    assert variants["committed"] == src
    assert set(variants) == {"committed", "no_c_store", "serial_epilogue",
                             "epi_chunks_16", "wait_without_watchdog"}
    assert all(v != src for name, v in variants.items()
               if name != "committed")
