"""The transfer modes' host prep and value types, held against bof_tpu.

FlashConfig.transfer_dtype 'bfloat16'/'int8' round operands on the host
before they cross the link.  The port's helpers (bof_tpu_torch/io/native.py
`quantize_i8`, `cast_bf16`, `ell_fill`'s bf16 mode; sparse/spmm_device.py
`quantize_ell_i8`, `ell_val_dtype`) must give bof_tpu's bits exactly, from
the native engine and from their numpy fallbacks alike: the port carries
bf16 as np.uint16 bits, bof_tpu as ml_dtypes.bfloat16.  Then the plain
versions of K2 and the SpMV on bf16 and (int8, row scale) values against
bof_tpu's XLA bodies (and its Pallas kernel, interpret mode, for bf16), at
tests/test_pallas.py's tolerance (rtol 1e-5, atol 1e-5: the values are
promoted exactly, only the summation order differs).
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import bof_tpu
from bof_tpu.io import native as ref_native
from bof_tpu.sparse import spmm_device as ref_sdev
from bof_tpu.sparse.spmm_pallas import spmm_ell_pallas
import bof_tpu_torch
from bof_tpu_torch.io import native as port_native
from bof_tpu_torch.sparse import spmm_device as port_sdev
from bof_tpu_torch.sparse.spmm_cuda import (ELL_VARIANTS, promote_vals,
                                            spmm_ell, spmv_ell)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = np.dtype(ml_dtypes.bfloat16)


def _special_values(rng, n=4096):
    """Normals over many binades, then the edge cases: NaN (quiet and
    with payloads), +-Inf, +-0, subnormals, the largest finite values
    (which round to Inf), and exact bf16 rounding ties both ways."""
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
         ).astype(np.float32)
    bits = np.array([0x7FC00000, 0x7FA00000, 0xFFC00001, 0x7F800001,
                     0x7F800000, 0xFF800000, 0x00000000, 0x80000000,
                     0x00000001, 0x807FFFFF, 0x00400000, 0x7F7FFFFF,
                     0xFF7FFFFF, 0x3F808000, 0x3F818000, 0xBF808000,
                     0x3F80FFFF, 0x3F817FFF], np.uint32)
    return np.concatenate([x, bits.view(np.float32)])


def _ref_bf16_bits(x):
    return np.asarray(ref_native.cast_bf16(x)).view(np.uint16)


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_cast_bf16_is_the_reference_bits(rng, impl):
    x = _special_values(rng)
    got = (port_native.cast_bf16(x) if impl == "native"
           else port_native.cast_bf16_numpy(x))
    assert got.dtype == np.uint16 and got.shape == x.shape
    np.testing.assert_array_equal(got, _ref_bf16_bits(x))
    # and ml_dtypes' rounding wherever it defines the bits (every value
    # but the NaN payloads, which it canonicalizes)
    finite = ~np.isnan(x)
    np.testing.assert_array_equal(
        got[finite], x[finite].astype(BF16).view(np.uint16))
    assert np.isnan(port_native.bf16_to_f32(got[~finite])).all()
    # the widening is exact: bf16 values come back as they were
    widened = port_native.bf16_to_f32(got)
    np.testing.assert_array_equal(widened[finite],
                                  x[finite].astype(BF16).astype(np.float32))


@pytest.mark.parametrize("case", ["normal", "special", "all_zero", "empty",
                                  "inf", "nan_only", "tie_halves"])
@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_quantize_i8_is_the_reference_bits(rng, case, impl):
    x = {"normal": rng.standard_normal((37, 29)).astype(np.float32),
         "special": _special_values(rng, 64)[-40:],
         "all_zero": np.zeros((8, 8), np.float32),
         "empty": np.zeros((0, 5), np.float32),
         "inf": np.array([1.0, -np.inf, 3.0, 0.5], np.float32),
         "nan_only": np.full(7, np.nan, np.float32),
         # max 127 makes scale 1, so x * inv = x: exact .5 ties, rounded
         # to even, and -0
         "tie_halves": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -0.0,
                                 126.5], np.float32)}[case]
    fn = (port_native.quantize_i8 if impl == "native"
          else port_native.quantize_i8_numpy)
    q, scale = fn(x)
    want_q, want_scale = ref_native.quantize_i8(x)
    assert q.dtype == np.int8 and q.shape == x.shape
    assert isinstance(scale, float) and scale == want_scale
    np.testing.assert_array_equal(q, want_q)
    if case in ("normal", "tie_halves", "all_zero", "empty"):
        # where it is defined, bof_tpu's own numpy fallback agrees too
        fq, fscale = _ref_numpy_quantize(x)
        np.testing.assert_array_equal(q, fq)
        assert scale == fscale
    if case == "tie_halves":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, 0, 126]


def _ref_numpy_quantize(x):
    """bof_tpu's quantize_i8 with its engine hidden: its numpy fallback."""
    saved = ref_native._lib
    ref_native._lib = None
    load = ref_native.load_library
    ref_native.load_library = lambda: None
    try:
        return ref_native.quantize_i8(x)
    finally:
        ref_native.load_library = load
        ref_native._lib = saved


@pytest.mark.parametrize("rows", [0, 1, 9, 40])
def test_quantize_ell_i8_is_the_reference(rng, rows):
    va = rng.standard_normal((rows, 16)).astype(np.float32)
    if rows:
        va[:, 10:] = 0.0             # padding slots
        va[0] = 0.0                  # an all-zero row: scale 1
        va[-1, 3] = np.nan           # ignored by the row max, quantized 0
        va[-1, 4] = 200.0
    q, scale = port_sdev.quantize_ell_i8(va)
    want_q, want_scale = ref_sdev.quantize_ell_i8(va)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(q, want_q)
    np.testing.assert_array_equal(scale, want_scale)


def _csr_block(rng, rows=37, k=60000, max_row=16):
    counts = rng.integers(0, max_row + 1, rows).astype(np.int64)
    counts[5] = 0
    starts = np.zeros(rows, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    nnz = int(counts.sum())
    ja = rng.integers(0, k, nnz).astype(np.int64)
    va = _special_values(rng, nnz)[-nnz:] if nnz > 40 else \
        rng.standard_normal(nnz).astype(np.float32)
    return starts, counts, ja, va


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("idt", [np.int32, np.uint16])
def test_bf16_ell_fill_is_the_reference_bits(rng, impl, idt, monkeypatch):
    """The bf16 value mode of the ELL fill (val_dtype np.uint16 for fp32
    values) against bof_tpu's (ml_dtypes.bfloat16), engine and numpy
    chain alike, through each package's to_ell."""
    starts, counts, ja, va = _csr_block(rng)
    ia = np.concatenate([starts, [starts[-1] + counts[-1]]])
    if impl == "numpy":
        monkeypatch.setattr(port_native, "ell_fill",
                            lambda *a, **k: None)
    else:
        assert port_native.ell_fill(starts, counts, ja, va, 64, 16, idt,
                                    np.uint16) is not None
    got_ja, got_va = port_sdev.to_ell(ia, ja, va, idx_dtype=idt,
                                      val_dtype=np.uint16)
    want_ja, want_va = ref_sdev.to_ell(ia, ja, va, idx_dtype=idt,
                                       val_dtype=BF16)
    assert got_va.dtype == np.uint16
    np.testing.assert_array_equal(got_ja, want_ja)
    np.testing.assert_array_equal(got_va, want_va.view(np.uint16))


@pytest.mark.parametrize("mode,want", [("float32", np.float32),
                                       ("bfloat16", np.uint16),
                                       ("int8", np.float32)])
@pytest.mark.parametrize("storage", [np.float32, np.float64])
def test_ell_value_dtypes_follow_the_reference(tmp_path, mode, want,
                                               storage):
    """ell_val_dtype / ell_val_quantize decide as bof_tpu's do; bf16 is
    marked by uint16 bits, and fp64 storage opts out of both modes."""
    ref_cfg = bof_tpu.FlashConfig(scratch_dir=str(tmp_path),
                                  transfer_dtype=mode)
    cfg = bof_tpu_torch.config_from_reference(dataclasses.asdict(ref_cfg),
                                              device="cpu")
    got = port_sdev.ell_val_dtype(storage, cfg)
    ref = ref_sdev.ell_val_dtype(storage, ref_cfg)
    assert got == (want if storage == np.float32 else storage)
    assert (got == np.uint16) == (ref == BF16)
    assert port_sdev.ell_val_quantize(storage, cfg) \
        == ref_sdev.ell_val_quantize(storage, ref_cfg) \
        == (mode == "int8" and storage == np.float32)


def _ell_values(rng, rows, rmax, k, cb, vkind):
    """A padded ELL block as bof_tpu's planner builds it (padding ja 0,
    va 0), its values in the transfer mode's type for both packages:
    (ja, port values, port scale or None, reference values, B)."""
    counts = rng.integers(0, rmax + 1, rows)
    ja = rng.integers(0, k, (rows, rmax)).astype(np.int32)
    va = rng.standard_normal((rows, rmax)).astype(np.float32)
    pad = np.arange(rmax)[None, :] >= counts[:, None]
    ja[pad] = 0
    va[pad] = 0.0
    b = rng.standard_normal((k, cb)).astype(np.float32)
    if vkind == "bf16":
        bits = port_native.cast_bf16(va)
        return ja, torch.from_numpy(bits.view(np.int16)).view(
            torch.bfloat16), None, bits.view(BF16), b
    q, scale = port_sdev.quantize_ell_i8(va)
    return (ja, torch.from_numpy(q), torch.from_numpy(scale),
            (jnp.asarray(q), jnp.asarray(scale)), b)


@pytest.mark.parametrize("vkind", ["bf16", "s8"])
@pytest.mark.parametrize("rows,rmax,k,cb", [(64, 20, 256, 128),
                                            (13, 2, 300, 37),
                                            (8, 700, 64, 64)])
def test_spmm_plain_on_low_precision_values(rng, vkind, rows, rmax, k, cb):
    """K2's plain version on bf16 and on (int8, row scale) values against
    bof_tpu's XLA body, which promotes them in HBM first; bf16 also
    against the Pallas kernel (interpret mode)."""
    ja, va, scale, ref_va, b = _ell_values(rng, rows, rmax, k, cb, vkind)
    before = dict(spmm_ell.variant_launches)
    got = spmm_ell(torch.from_numpy(b), torch.from_numpy(ja), va,
                   va_scale=scale)
    assert spmm_ell.variant_launches == before, "the CPU launches nothing"
    want = np.asarray(ref_sdev.spmm_ell_block(b, ja, ref_va))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if vkind == "bf16" and cb % 128 == 0 and rows % 8 == 0:
        pal = np.asarray(spmm_ell_pallas(jnp.asarray(b), jnp.asarray(ja),
                                         jnp.asarray(ref_va),
                                         interpret=True))
        np.testing.assert_allclose(got.numpy(), pal, **TOL)


@pytest.mark.parametrize("vkind", ["bf16", "s8"])
@pytest.mark.parametrize("rows,rmax,k", [(64, 20, 256), (13, 2, 300),
                                         (8, 700, 64)])
def test_spmv_plain_on_low_precision_values(rng, vkind, rows, rmax, k):
    ja, va, scale, ref_va, _ = _ell_values(rng, rows, rmax, k, 1, vkind)
    x = rng.standard_normal(k).astype(np.float32)
    got = spmv_ell(torch.from_numpy(x), torch.from_numpy(ja), va,
                   va_scale=scale)
    want = np.asarray(ref_sdev.spmv_ell_block(x, ja, ref_va))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_int8_values_promote_as_the_reference():
    """v = float(q) * scale in one fp32 rounding, bit for bit bof_tpu's
    promote_ell_vals."""
    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, (16, 9)).astype(np.int8)
    scale = (rng.random(16) * 1e-2).astype(np.float32)
    got = promote_vals(torch.from_numpy(q), torch.from_numpy(scale))
    want = np.asarray(ref_sdev.promote_ell_vals(
        (jnp.asarray(q), jnp.asarray(scale)), jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["scale_missing", "scale_without_int8",
                                 "scale_shape", "value_type"])
def test_ell_wrappers_reject_mismatched_values(bad):
    ja = torch.zeros((4, 3), dtype=torch.int32)
    b = torch.zeros((5, 2))
    va, scale, err = torch.zeros((4, 3), dtype=torch.int8), None, ValueError
    if bad == "scale_without_int8":
        va, scale = torch.zeros((4, 3)), torch.ones(4)
    elif bad == "scale_shape":
        scale = torch.ones(3)
    elif bad == "value_type":
        va, err = torch.zeros((4, 3), dtype=torch.float16), TypeError
    with pytest.raises(err):
        spmm_ell(b, ja, va, va_scale=scale)
    with pytest.raises(err):
        spmv_ell(torch.zeros(5), ja, va, va_scale=scale)


def test_value_variants_are_counted_apart():
    assert ELL_VARIANTS == ("f32", "bf16", "s8")
    assert set(spmm_ell.variant_launches) == set(ELL_VARIANTS)
    assert set(spmv_ell.variant_launches) == set(ELL_VARIANTS)
