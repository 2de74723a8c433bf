"""The port's map, reduce and out-of-core sample sort against bof_tpu's,
on the same seeded inputs, on the CPU; and B10's plain version, the
device block sorter, against jnp.sort.

Every case of tests/test_map_reduce_sort.py runs here through both
packages (bof_tpu on CPU JAX, the port on `device='cpu'`, where B10 takes
its plain version and map's fn runs on CPU tensors).  Tolerances: sort,
reduce and map with arithmetic or sqrt on normal numbers bit for bit
against bof_tpu, except torch.sqrt on the CPU, within one unit in the
last place (torch's CPU sqrt is not correctly rounded: on about 0.5 % of
inputs it differs from np.sqrt and XLA in the last bit; on the card it
is, and tests/test_torch_cuda.py and chip_smoke.py hold it bit for bit
to np.sqrt); transcendental functions at the repo's fp32 rtol 2e-4; the
device-mode sort bit for bit against bof_tpu's own
device mode (jnp.sort), also on +-0.0, NaNs of both signs with payloads
and duplicates; float sums against float64 numpy at bof_tpu's rtol 1e-10.

bof_tpu's jit-cache and tail-padding cases become cases of what the port
does instead: every callable kind maps (a numpy ufunc through torch's
function of its name), and the tail block's result is right without
padding.  Two deliberate differences are pinned: a jax.numpy fn cannot
run in the port's bof_map, and a value fn captures is read on every call
(bof_tpu's jit keeps its first trace's).
"""
import dataclasses
import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bof_tpu
import bof_tpu_torch
from bof_tpu.core.flash_array import FlashArray as RefFlashArray
from bof_tpu.ops import bof_map as ref_map
from bof_tpu.ops import bof_reduce as ref_reduce
from bof_tpu.ops import bof_sort as ref_sort
from bof_tpu_torch.core.flash_array import FlashArray as PortFlashArray
from bof_tpu_torch.ops import bof_map, bof_reduce, bof_sort
from bof_tpu_torch.ops import map_reduce as port_mr
from bof_tpu_torch.ops import sort_cuda


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


def _set(ctxs, **kw):
    for c in ctxs:
        for key, val in kw.items():
            setattr(c.config, key, val)


def _pair(ctxs, shape, dtype, data=None, **kw):
    """The same mem_array in bof_tpu and in the port."""
    return (bof_tpu.mem_array(shape, dtype, data=None if data is None
                              else data.copy(), ctx=ctxs[0], **kw),
            bof_tpu_torch.mem_array(shape, dtype, data=None if data is None
                                    else data.copy(), ctx=ctxs[1], **kw))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _within_one_ulp(got, ref):
    """torch.sqrt on the CPU against a correctly rounded sqrt."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


def _map_both(ctxs, data, ref_fn, port_fn, blk, dst_dtype=None):
    n = len(data)
    rs, ps = _pair(ctxs, (n,), data.dtype, data)
    rd, pd = _pair(ctxs, (n,), dst_dtype or data.dtype)
    ref_map(rs, rd, ref_fn, blk_elems=blk, ctx=ctxs[0])
    bof_map(ps, pd, port_fn, blk_elems=blk, ctx=ctxs[1])
    return rd.read_all(), pd.read_all()


def _sort_both(ctxs, data, **kw):
    n = len(data)
    rs, ps = _pair(ctxs, (n,), data.dtype, data)
    rd, pd = _pair(ctxs, (n,), data.dtype)
    ref_sort(rs, rd, ctx=ctxs[0], **kw)
    bof_sort(ps, pd, ctx=ctxs[1], **kw)
    return rd.read_all(), pd.read_all()


def test_map_sqrt(ctxs, rng):
    data = np.abs(rng.standard_normal(10_000)).astype(np.float32)
    ref, got = _map_both(ctxs, data, lambda x: jnp.sqrt(x),
                         lambda x: torch.sqrt(x), 1024)
    _within_one_ulp(got, ref)
    _same_bits(ref, np.sqrt(data))


@pytest.mark.parametrize("ufunc", [np.exp, np.tanh, np.log1p])
def test_map_transcendental(ctxs, rng, ufunc):
    """A transcendental numpy ufunc runs as torch's function of its name in
    the port and as jax.numpy's in bof_tpu: the two libraries round the
    last bits differently, so held at the repo's fp32 rtol 2e-4."""
    data = rng.standard_normal(5000).astype(np.float32)
    data = np.abs(data) if ufunc is np.log1p else data
    ref, got = _map_both(ctxs, data, ufunc, ufunc, 1024)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=2e-4)
    np.testing.assert_allclose(got, ufunc(data.astype(np.float64)),
                               rtol=2e-4)


def test_map_every_callable_kind(ctxs, rng):
    """The port's counterpart of bof_tpu's jit-cache case: a numpy ufunc
    resolves to torch's function of its name (and one torch lacks raises
    TypeError naming it, before any block runs); a lambda, a builtin and
    an unhashable callable object each map the blocks as bof_tpu's do."""
    assert port_mr._torch_fn(np.sqrt) is torch.sqrt
    assert port_mr._torch_fn(np.abs) is torch.absolute  # np.abs.__name__
    with pytest.raises(TypeError, match="torch equivalent"):
        port_mr._torch_fn(np.isnat)  # datetime ufunc: no torch namesake
    f = lambda x: x + 1  # noqa: E731
    assert port_mr._torch_fn(f) is f
    data = np.abs(rng.standard_normal(4_000)).astype(np.float32) - 0.5

    class UnhashableFn:
        __hash__ = None

        def __call__(self, x):
            return x * 2.0
    for fn in (np.abs, abs, UnhashableFn(), f):
        ref, got = _map_both(ctxs, data, fn, fn, 512)
        _same_bits(got, ref)
    _, pd = _pair(ctxs, (4000,), np.float32)
    ps = bof_tpu_torch.mem_array((4000,), np.float32, data=data,
                                 ctx=ctxs[1])
    with pytest.raises(TypeError, match=r"torch\.isnat does not exist"):
        bof_map(ps, pd, np.isnat, blk_elems=512, ctx=ctxs[1])


def test_map_in_place(ctxs, rng):
    data = rng.standard_normal(5000).astype(np.float32)
    rs, ps = _pair(ctxs, (5000,), np.float32, data)
    ref_map(rs, rs, lambda x: x * 2.0 + 1.0, blk_elems=999, ctx=ctxs[0])
    bof_map(ps, ps, lambda x: x * 2.0 + 1.0, blk_elems=999, ctx=ctxs[1])
    _same_bits(ps.read_all(), rs.read_all())
    np.testing.assert_allclose(ps.read_all(), data * 2.0 + 1.0, rtol=1e-6)


def test_reduce_sum_max_min(ctxs, rng):
    data = rng.standard_normal(33_333).astype(np.float32)
    rs, ps = _pair(ctxs, (len(data),), np.float32, data)
    for op in ("sum", "max", "min"):
        want = ref_reduce(rs, op, blk_elems=4096, ctx=ctxs[0])
        got = bof_reduce(ps, op, blk_elems=4096, ctx=ctxs[1])
        assert got == want and type(got) is type(want), op
    np.testing.assert_allclose(bof_reduce(ps, "sum", blk_elems=4096,
                                          ctx=ctxs[1]),
                               data.astype(np.float64).sum(), rtol=1e-10)


def test_map_then_reduce_driver_composition(ctxs, rng):
    """The reference's map_reduce driver: map=sqrt then reduce=sum
    (reference: drivers/map_reduce.cpp)."""
    n = 20_000
    data = np.abs(rng.standard_normal(n)).astype(np.float32) + 1.0
    rs, ps = _pair(ctxs, (n,), np.float32, data)
    rd, pd = _pair(ctxs, (n,), np.float32)
    ref_map(rs, rd, jnp.sqrt, blk_elems=3000, ctx=ctxs[0])
    bof_map(ps, pd, torch.sqrt, blk_elems=3000, ctx=ctxs[1])
    _within_one_ulp(pd.read_all(), rd.read_all())
    got = bof_reduce(pd, "sum", blk_elems=3000, ctx=ctxs[1])
    want = ref_reduce(rd, "sum", blk_elems=3000, ctx=ctxs[0])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, np.sqrt(data.astype(np.float64)).sum(),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint32])
def test_sort_dtypes(ctxs, rng, dtype, tmp_path):
    n = 50_000
    if np.issubdtype(dtype, np.floating):
        data = rng.standard_normal(n).astype(dtype)
    else:
        data = rng.integers(0, 1 << 30, n).astype(dtype)
    outs = []
    for pkg, ctx, tag in ((bof_tpu, ctxs[0], "r"),
                          (bof_tpu_torch, ctxs[1], "p")):
        src = pkg.map_array(str(tmp_path / f"s{tag}.bin"), (n,), dtype,
                            create=True, ctx=ctx)
        src.write_all(data)
        dst = pkg.map_array(str(tmp_path / f"d{tag}.bin"), (n,), dtype,
                            create=True, ctx=ctx)
        pkg.ops.bof_sort(src, dst, blk_elems=4096, ctx=ctx)
        outs.append(dst.read_all())
    _same_bits(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], np.sort(data))


def test_sort_descending(ctxs, rng):
    data = rng.standard_normal(30_000).astype(np.float32)
    ref, got = _sort_both(ctxs, data, descending=True, blk_elems=4096)
    _same_bits(got, ref)
    np.testing.assert_array_equal(got, np.sort(data)[::-1])


def test_sort_single_block(ctxs, rng):
    data = rng.standard_normal(100).astype(np.float32)
    ref, got = _sort_both(ctxs, data, blk_elems=4096)
    _same_bits(got, ref)
    np.testing.assert_array_equal(got, np.sort(data))


def test_sort_with_duplicates(ctxs, rng):
    data = rng.integers(0, 50, 40_000).astype(np.int64)
    ref, got = _sort_both(ctxs, data, blk_elems=3000)
    _same_bits(got, ref)
    np.testing.assert_array_equal(got, np.sort(data))


def test_sort_custom_key(ctxs, rng):
    """Comparator analog: sort by |x| via a key function (stable, so the
    two packages agree element for element)."""
    data = rng.standard_normal(25_000).astype(np.float32)
    ref, got = _sort_both(ctxs, data, key=np.abs, blk_elems=3000)
    _same_bits(got, ref)
    np.testing.assert_array_equal(np.abs(got), np.sort(np.abs(data)))


def test_sort_device_compute(ctxs, rng):
    """sort_compute='device' runs the block sorts through B10 (its plain
    version on a CPU device) and gives bof_tpu's device bits."""
    _set(ctxs, sort_compute="device")
    data = rng.standard_normal(20_000).astype(np.float32)
    before = sort_cuda.sort_block.launches
    ref, got = _sort_both(ctxs, data, blk_elems=4096)
    _same_bits(got, ref)
    np.testing.assert_array_equal(got, np.sort(data))
    assert sort_cuda.sort_block.launches == before  # no card, no kernel


def test_sort_empty_input(ctxs):
    for pkg, ctx in zip((bof_tpu, bof_tpu_torch), ctxs):
        src = pkg.flash_empty((0,), np.float32, ctx=ctx)
        dst = pkg.flash_empty((0,), np.float32, ctx=ctx)
        pkg.ops.bof_sort(src, dst, ctx=ctx)  # a no-op, not a crash


def test_map_float64_exact(ctxs, rng):
    """float64 blocks run fn (np.sqrt) on the host numpy block, exactly, in
    both packages."""
    data = np.abs(rng.standard_normal(4097)) + 1e-9
    ref, got = _map_both(ctxs, data, np.sqrt, np.sqrt, 1000)
    _same_bits(got, ref)
    np.testing.assert_array_equal(got, np.sqrt(data))


def test_map_float64_narrowing_fn_raises(ctxs, rng):
    """A fn that returns float32 for a float64 destination raises a
    diagnosable error; nothing narrowed is stored."""
    n = 64
    data = rng.standard_normal(n)
    ps = bof_tpu_torch.mem_array((n,), np.float64, data=data, ctx=ctxs[1])
    pd = bof_tpu_torch.mem_array((n,), np.float64, data=np.zeros(n),
                                 ctx=ctxs[1])
    with pytest.raises(RuntimeError) as ei:  # scheduler wraps task errors
        bof_map(ps, pd, lambda x: x.astype(np.float32) * 2.0,
                blk_elems=32, ctx=ctxs[1])
    assert "float32" in str(ei.value.__cause__)
    assert not pd.read_all().any()


def test_sort_float64_device_mode_falls_back(ctxs, rng):
    """sort_compute='device' with fp64 elements: B10 has no 64-bit key, so
    the sorter takes the host path and stays bit-exact, as bof_tpu's
    does."""
    _set(ctxs, sort_compute="device")
    data = rng.standard_normal(20_000) * (1.0 + 1e-12)
    before = sort_cuda.sort_block.launches
    ref, got = _sort_both(ctxs, data, blk_elems=3000)
    _same_bits(got, ref)
    np.testing.assert_array_equal(got, np.sort(data))
    assert not sort_cuda.device_sortable(np.float64)
    assert sort_cuda.sort_block.launches == before


def test_sort_device_mode_preserves_nans(ctxs, rng):
    """Device block sort with NaN elements keeps exactly the real NaNs
    (bof_tpu needed NaN padding for that; the port sorts the block
    unpadded), bit for bit bof_tpu's device result."""
    _set(ctxs, sort_compute="device")
    n = 10_000
    data = rng.standard_normal(n).astype(np.float32)
    data[rng.choice(n, 37, replace=False)] = np.nan
    ref, got = _sort_both(ctxs, data, blk_elems=3000)
    _same_bits(got, ref)
    want = np.sort(data)
    np.testing.assert_array_equal(got[:n - 37], want[:n - 37])
    assert np.isnan(got[n - 37:]).all()


def test_sort_rejects_overlapping_output(ctxs, rng):
    """Phase 3 reads source fragments while writing dst: an aliased or
    overlapping output raises; a same-store disjoint view is legal."""
    x = rng.standard_normal(256).astype(np.float32)
    src = bof_tpu_torch.mem_array((256,), np.float32, data=x, ctx=ctxs[1])
    with pytest.raises(ValueError, match="overlap"):
        bof_sort(src, src, blk_elems=64, ctx=ctxs[1])
    outs = []
    for pkg, FA, ctx in ((bof_tpu, RefFlashArray, ctxs[0]),
                         (bof_tpu_torch, PortFlashArray, ctxs[1])):
        big = pkg.mem_array((512,), np.float32, ctx=ctx)
        s2 = FA(big.store, (256,), np.float32, "R", offset=0, ctx=ctx)
        d2 = FA(big.store, (256,), np.float32, "R", offset=1024, ctx=ctx)
        s2.write_all(x)
        pkg.ops.bof_sort(s2, d2, blk_elems=64, ctx=ctx)
        outs.append(d2.read_all())
    _same_bits(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], np.sort(x))


def test_sort_rejects_same_file_opened_twice(ctxs, tmp_path, rng):
    """store_uid differs across two open_store calls on one path, so the
    overlap guard uses inode identity (same_backing), not uids."""
    x = rng.standard_normal(256).astype(np.float32)
    p = str(tmp_path / "alias.bin")
    src = bof_tpu_torch.map_array(p, (256,), np.float32, create=True,
                                  ctx=ctxs[1])
    src.write_all(x)
    dst = bof_tpu_torch.map_array(p, (256,), np.float32, ctx=ctxs[1])
    with pytest.raises(ValueError, match="overlap"):
        bof_sort(src, dst, blk_elems=64, ctx=ctxs[1])


def test_map_rejects_partial_overlap_allows_exact_inplace(ctxs, rng):
    x = rng.standard_normal(256).astype(np.float32)
    outs = []
    for pkg, FA, ctx in ((bof_tpu, RefFlashArray, ctxs[0]),
                         (bof_tpu_torch, PortFlashArray, ctxs[1])):
        big = pkg.mem_array((512,), np.float32, ctx=ctx)
        s = FA(big.store, (256,), np.float32, "R", offset=0, ctx=ctx)
        d_part = FA(big.store, (256,), np.float32, "R", offset=512, ctx=ctx)
        s.write_all(x)
        with pytest.raises(ValueError, match="alias|overlap"):
            pkg.ops.bof_map(s, d_part, lambda v: v * 2.0, blk_elems=64,
                            ctx=ctx)
        pkg.ops.bof_map(s, s, lambda v: v * 2.0, blk_elems=64, ctx=ctx)
        outs.append(s.read_all())
    _same_bits(outs[1], outs[0])
    np.testing.assert_allclose(outs[1], x * 2.0, rtol=1e-6)


def test_map_tail_block_is_right(ctxs, rng):
    """A length that is no multiple of the block: bof_tpu pads the tail to
    the block's shape (to bound XLA compiles), the port maps the tail as
    it is; the tail's result is the same, bit for bit."""
    n, blk = 300, 128  # tail of 44
    x = rng.standard_normal(n).astype(np.float32)
    ref, got = _map_both(ctxs, x, lambda v: v + 1.0, lambda v: v + 1.0, blk)
    _same_bits(got, ref)
    np.testing.assert_array_equal(got[256:], x[256:] + np.float32(1.0))


def test_map_rejects_silent_dtype_cast(ctxs, rng):
    x = rng.standard_normal(64).astype(np.float32)
    src = bof_tpu_torch.mem_array((64,), np.float32, data=x, ctx=ctxs[1])
    dst = bof_tpu_torch.mem_array((64,), np.int32, ctx=ctxs[1])
    with pytest.raises(RuntimeError) as ei:
        bof_map(src, dst, lambda v: v * 2.0, blk_elems=32, ctx=ctxs[1])
    assert "returned float32" in str(ei.value.__cause__)


def test_reduce_int64_sum_exact_past_2_53(ctxs):
    """Integer sums fold in their own 64-bit family, as bof_tpu's do."""
    vals = np.array([2 ** 62, 1, 1, 1, -(2 ** 62)] + [1] * 11, np.int64)
    uv = np.array([2 ** 63, 1, 2, 3], np.uint64)
    for data, blk in ((vals, 4), (uv, 2)):
        rs, ps = _pair(ctxs, (len(data),), data.dtype, data)
        got = bof_reduce(ps, "sum", blk_elems=blk, ctx=ctxs[1])
        want = ref_reduce(rs, "sum", blk_elems=blk, ctx=ctxs[0])
        assert got == want == data.sum()
        assert np.asarray(got).dtype == np.asarray(want).dtype == data.dtype


def test_sort_bool_device_path(ctxs, rng):
    """bool in device mode: B10 sorts it as uint8 (its plain version here),
    on non-power-of-two blocks, bit for bit bof_tpu's device result."""
    _set(ctxs, sort_compute="device")
    x = rng.random(300) > 0.5
    assert sort_cuda.device_sortable(np.bool_)
    ref, got = _sort_both(ctxs, x, blk_elems=100)
    _same_bits(got, ref)
    np.testing.assert_array_equal(got, np.sort(x))


def test_sort_duplicate_heavy_raises_clearly(tmp_path):
    """All-equal keys collapse into one bucket; when that bucket exceeds
    the program budget the failure is an up-front ValueError."""
    small = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
        scratch_dir=str(tmp_path / "s"), program_budget=8 << 20,
        n_io_threads=2, n_compute_threads=1, device="cpu"))
    try:
        n = 2_000_000
        src = bof_tpu_torch.mem_array((n,), np.float32,
                                      data=np.full(n, 7.0, np.float32),
                                      ctx=small)
        dst = bof_tpu_torch.mem_array((n,), np.float32, ctx=small)
        with pytest.raises(ValueError, match="duplicate-heavy"):
            bof_sort(src, dst, blk_elems=1 << 18, ctx=small)
    finally:
        small.destroy()


# ---------------------------------------------------------------- B10 bits

def _specials(rng, n, dtype):
    """Seeded elements of `dtype` with duplicates and, for floats, +-0.0,
    +-inf and NaNs of both signs with payloads."""
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.random(n) > 0.5
    if dt.kind in "iu":
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        x[rng.choice(n, n // 4, replace=False)] = x[:8][
            rng.integers(0, 8, n // 4)]  # duplicates
        return x
    x = np.round(rng.standard_normal(n), 1).astype(dt)  # many duplicates
    ubits = np.uint32 if dt.itemsize == 4 else np.uint16
    b = x.view(ubits)
    if dt.itemsize == 4:
        specials = [0x80000000, 0x00000000, 0x7F800000, 0xFF800000,
                    0x7FC00000, 0xFFC00000, 0x7FC00123, 0xFF800001,
                    0x7F800777]
    else:
        specials = [0x8000, 0x0000, 0x7C00, 0xFC00, 0x7E00, 0xFE00, 0x7E12,
                    0xFC01, 0x7C07]
    at = rng.choice(n, n // 8, replace=False)
    b[at] = np.array(specials, ubits)[rng.integers(0, len(specials),
                                                   len(at))]
    return x


SORT_DTYPES = [np.float32, np.float16, np.int32, np.uint32, np.int16,
               np.uint16, np.int8, np.uint8, np.bool_]


@pytest.mark.parametrize("dtype", SORT_DTYPES)
def test_sort_block_plain_is_jnp_sort(rng, dtype):
    """B10's plain version (what the kernel is held to on the card) gives
    jnp.sort's bits: stable, -0.0 == +0.0 in input order, every NaN equal
    and last, each element's own bits."""
    x = _specials(rng, 20_011, dtype)
    got = sort_cuda.sort_block(sort_cuda.bits_of(x), x.dtype).numpy()
    _same_bits(got.view(x.dtype), np.asarray(jnp.sort(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int16,
                                   np.uint8])
def test_device_sort_is_bof_tpus_device_sort_bit_for_bit(ctxs, rng, dtype):
    """The whole out-of-core sort in device mode (phase 1 blocks and phase
    3 buckets through B10's plain version) against bof_tpu's device mode
    (jnp.sort), on +-0.0, signed NaNs with payloads and duplicates, and
    against a stable sort of the input by B10's keys (the out-of-core sort
    is stable under them), ascending and descending."""
    _set(ctxs, sort_compute="device")
    x = _specials(rng, 30_001, dtype)
    keys = sort_cuda.canonical_keys(sort_cuda.bits_of(x), x.dtype).numpy()
    stable = x[np.argsort(keys, kind="stable")]
    ref, got = _sort_both(ctxs, x, blk_elems=4000)
    _same_bits(got, ref)
    _same_bits(got, stable)
    ref, got = _sort_both(ctxs, x, blk_elems=4000, descending=True)
    _same_bits(got, ref)


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sort_max_elems_is_the_kernel_tile():
    """sort_block's tile and limit are csrc/sort.cu's: the kernel indexes
    with ints over whole tiles of SORT_THREADS * SORT_ITEMS elements, so it
    takes at most 2^31 - SORT_TILE of them, and refuses more itself."""
    with open(os.path.join(_ROOT, "bof_tpu_torch", "csrc", "sort.cu")) as f:
        src = f.read()
    threads = int(re.search(r"constexpr int SORT_THREADS = (\d+);",
                            src).group(1))
    items = int(re.search(r"constexpr int SORT_ITEMS = (\d+);", src).group(1))
    assert "constexpr int SORT_TILE = SORT_THREADS * SORT_ITEMS;" in src
    assert "if (n > (1LL << 31) - SORT_TILE)" in src
    assert sort_cuda.SORT_TILE == threads * items
    assert sort_cuda.SORT_MAX_ELEMS == 2 ** 31 - threads * items


def test_b10_variant_tool_edits_apply_to_the_committed_kernel(tmp_path):
    """tools/torch_b10_variants.py times textual variants of csrc/sort.cu
    (the measurements PERF.md cites): each edit must still find its text
    in the committed source, once; the first design comes from the file
    it is given; ptxas's notes are read a kernel at a time."""
    spec = importlib.util.spec_from_file_location(
        "b10_variants", os.path.join(_ROOT, "tools", "torch_b10_variants.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(tool.CSRC, "sort.cu")) as f:
        src = f.read()
    first = tmp_path / "first.cu"
    first.write_text("// the first design\n")
    variants = tool._variants(src, str(first))
    assert set(variants) == set(tool.NAMES)
    assert variants["committed"] == src
    assert variants[tool.FIRST] == "// the first design\n"
    assert "constexpr int SORT_ITEMS = 12;" in variants["items_12"]
    assert "constexpr int SORT_THREADS = 256;" in variants["threads_256"]
    assert "__match_any_sync(FULL, d);" in variants["match_any"]
    assert "st.release.gpu" in variants["release_acquire"]
    assert len(set(variants.values())) == len(tool.NAMES)
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_120sort_onesweep_kernelILi0EEEvPKjPjPKiPyPiii'"
           " for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN...\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 56 registers, 25604 bytes smem\n")
    assert tool._ptxas_notes(log) == [
        "sort_onesweep_kernel<f32>: 56 registers, 25604 bytes smem; "
        "0 bytes spill stores, 0 bytes spill loads"]


def test_sort_device_mode_without_a_card_raises(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU-only contract does "
                    "not apply")
    ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
        scratch_dir=str(tmp_path / "s"), sort_compute="device"))
    try:
        x = rng.standard_normal(1000).astype(np.float32)
        src = bof_tpu_torch.mem_array((1000,), np.float32, data=x, ctx=ctx)
        dst = bof_tpu_torch.mem_array((1000,), np.float32, ctx=ctx)
        with pytest.raises(RuntimeError, match="cuda"):
            bof_sort(src, dst, blk_elems=300, ctx=ctx)
        with pytest.raises(RuntimeError, match="cuda"):
            bof_map(src, dst, torch.sqrt, blk_elems=300, ctx=ctx)
        _same_bits(src.read_all(), x)  # nothing sorted on the CPU instead
        assert not dst.read_all().any()
    finally:
        ctx.destroy()


# ------------------------------------------------ deliberate differences

def test_map_jnp_fn_cannot_run_in_the_port(ctxs, rng):
    """ROADMAP C (a): bof_tpu maps a numpy ufunc to jax.numpy and jits any
    fn; the port maps a ufunc to torch and runs fn on a torch tensor, so a
    jax.numpy fn raises TypeError and writes nothing (as does a fn that
    returns anything but a tensor), while np.sqrt runs as torch.sqrt."""
    data = np.abs(rng.standard_normal(1000)).astype(np.float32)
    ref, got = _map_both(ctxs, data, np.sqrt, np.sqrt, 256)
    _within_one_ulp(got, ref)
    rs, ps = _pair(ctxs, (1000,), np.float32, data)
    rd, pd = _pair(ctxs, (1000,), np.float32)
    ref_map(rs, rd, lambda v: jnp.sqrt(v), blk_elems=256, ctx=ctxs[0])
    _same_bits(rd.read_all(), ref)
    with pytest.raises(RuntimeError) as ei:
        bof_map(ps, pd, lambda v: jnp.sqrt(v), blk_elems=256, ctx=ctxs[1])
    assert isinstance(ei.value.__cause__, TypeError)
    assert not pd.read_all().any()
    with pytest.raises(RuntimeError) as ei:  # a host array is no tensor
        bof_map(ps, pd, lambda v: v.numpy() * 2.0, blk_elems=256,
                ctx=ctxs[1])
    assert "not a torch.Tensor" in str(ei.value.__cause__)
    assert not pd.read_all().any()


def test_map_reads_captured_values_on_every_call(ctxs, rng):
    """ROADMAP C (b): bof_tpu's jit bakes a captured value in at the first
    trace of a fn object (bof_tpu/ops/map_reduce.py:103-109); the port
    runs fn eagerly, so a second call sees the new value."""
    data = rng.standard_normal(1000).astype(np.float32)
    rs, ps = _pair(ctxs, (1000,), np.float32, data)
    rd, pd = _pair(ctxs, (1000,), np.float32)
    scale = [2.0]

    def fn(v):
        return v * scale[0]
    for (src, dst, ctx, mapper) in ((rs, rd, ctxs[0], ref_map),
                                    (ps, pd, ctxs[1], bof_map)):
        scale[0] = 2.0
        mapper(src, dst, fn, blk_elems=256, ctx=ctx)
        scale[0] = 3.0
        mapper(src, dst, fn, blk_elems=256, ctx=ctx)
    np.testing.assert_array_equal(rd.read_all(), data * np.float32(2.0))
    np.testing.assert_array_equal(pd.read_all(), data * np.float32(3.0))
