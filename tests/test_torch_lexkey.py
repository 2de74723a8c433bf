"""The port's multi-field sort keys (`bof_tpu_torch/utils/lexkey.py`) and
bof_sort's tuple-key and comparator paths, against bof_tpu's, on the CPU.

Every case of tests/test_lexkey.py runs here on the port: each composite
must be bof_tpu's byte for byte (or both must raise the same error), and
each sort must give bof_tpu's output bit for bit, besides the reference
tests' golden models (python `sorted()` over tuples and `np.lexsort`;
np.lexsort takes keys LAST-key-primary, lex_composite FIRST-key-primary).
"""
import numpy as np
import pytest

import dataclasses

import bof_tpu
import bof_tpu_torch
from bof_tpu.utils.lexkey import lex_composite as ref_lex
from bof_tpu_torch import mem_array
from bof_tpu_torch.utils.lexkey import lex_composite as port_lex


@pytest.fixture
def ctx(tmp_path):
    """The port's context on the CPU, configured as the reference tests'
    `ctx`, carrying a bof_tpu context as `.ref` for the same calls."""
    ref_cfg = bof_tpu.FlashConfig(scratch_dir=str(tmp_path / "scratch"),
                                  n_io_threads=4, n_compute_threads=2,
                                  program_budget=256 << 20)
    c = bof_tpu_torch.FlashContext(bof_tpu_torch.config_from_reference(
        dataclasses.asdict(ref_cfg), device="cpu"))
    c.ref = bof_tpu.FlashContext(ref_cfg)
    yield c
    c.ref.destroy()
    c.destroy()


def _both(ref_call, port_call):
    """port_call()'s result, after checking that ref_call() raises the
    same exception type, or gives the same bytes."""
    try:
        want = ref_call()
    except Exception as e:
        with pytest.raises(type(e)):
            port_call()
        raise
    got = port_call()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    return got


def lex_composite(cols):
    return _both(lambda: ref_lex(cols), lambda: port_lex(cols))


def bof_sort(src, dst, ctx, **kw):
    """The port's bof_sort, checked against bof_tpu's on the same input."""
    data = src.read_all()
    r_src = bof_tpu.mem_array(src.shape, src.dtype, data=data.copy(),
                              ctx=ctx.ref)
    r_dst = bof_tpu.mem_array(dst.shape, dst.dtype, ctx=ctx.ref)

    def ref_call():
        bof_tpu.bof_sort(r_src, r_dst, ctx=ctx.ref, **kw)
        return r_dst.read_all()

    def port_call():
        bof_tpu_torch.bof_sort(src, dst, ctx=ctx, **kw)
        return dst.read_all()
    _both(ref_call, port_call)


def _order_by_composite(cols):
    return np.argsort(lex_composite(cols), kind="stable")


def _order_by_lexsort(cols):
    # np.lexsort: last key is primary -> reverse the column order
    return np.lexsort(tuple(reversed([np.asarray(c) for c in cols])))


@pytest.mark.parametrize("dtypes", [
    (np.int32, np.int64),
    (np.int8, np.uint16),
    (np.uint64,),
    (np.float32, np.int32),
    (np.float64, np.float32, np.uint8),
    (np.bool_, np.int16),
])
def test_composite_matches_lexsort(rng, dtypes):
    n = 4000
    cols = []
    for dt in dtypes:
        dt = np.dtype(dt)
        if dt == np.bool_:
            cols.append(rng.integers(0, 2, n).astype(bool))
        elif np.issubdtype(dt, np.floating):
            # duplicates (incl. -0.0 from rounding negatives) force
            # tie-breaks through later columns — the composite
            # canonicalizes -0.0 == +0.0 exactly like lexsort
            cols.append(np.round(rng.standard_normal(n), 1).astype(dt))
        else:
            info = np.iinfo(dt)
            cols.append(rng.integers(info.min, info.max, n, dtype=dt,
                                     endpoint=True))
    got = _order_by_composite(cols)
    want = _order_by_lexsort(cols)
    np.testing.assert_array_equal(got, want)


def test_composite_float_specials():
    # +-0 are numerically equal and canonicalize to one key; compare
    # VALUE sequences (the permutation among equal zeros is input order)
    x = np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5,
                  np.finfo(np.float64).tiny, -np.finfo(np.float64).tiny],
                 np.float64)
    order = np.argsort(lex_composite((x,)), kind="stable")
    np.testing.assert_array_equal(x[order], np.sort(x))
    # positive NaN lands after +inf (numpy's NaN-last placement)
    y = np.array([1.0, np.nan, np.inf], np.float32)
    oy = np.argsort(lex_composite((y,)), kind="stable")
    assert np.isnan(y[oy][-1])


def test_composite_int_extremes():
    x = np.array([np.iinfo(np.int64).min, -1, 0, 1,
                  np.iinfo(np.int64).max], np.int64)
    order = np.argsort(lex_composite((x[::-1].copy(),)))
    np.testing.assert_array_equal(x[::-1][order], x)


def test_composite_negative_zero_tie_breaks_through_later_columns():
    """-0.0 and +0.0 are value-equal: they must map to ONE key so the
    next column decides the order (distinct keys would poison every
    subsequent column's tie-break)."""
    a = np.array([-0.0, 0.0, -0.0, 0.0], np.float64)
    b = np.array([3, 1, 2, 0], np.int64)
    got = np.argsort(lex_composite((a, b)), kind="stable")
    np.testing.assert_array_equal(got, np.lexsort((b, a)))
    # and within an all-zero primary the order is exactly b's
    np.testing.assert_array_equal(b[got], [0, 1, 2, 3])


def test_composite_nan_payloads_group_as_one_key():
    """Any-sign/any-payload NaNs canonicalize to one key (above +inf),
    so a later column breaks NaN ties — and placement matches numpy's
    NaN-last."""
    neg_nan = np.frombuffer(np.uint64(0xFFF8000000000123).tobytes(),
                            np.float64)[0]
    payload_nan = np.frombuffer(np.uint64(0x7FF8000000000456).tobytes(),
                                np.float64)[0]
    a = np.array([np.nan, 1.0, neg_nan, np.inf, payload_nan], np.float64)
    b = np.array([2, 9, 1, 9, 0], np.int64)
    order = np.argsort(lex_composite((a, b)), kind="stable")
    # finite/inf first, then the three NaNs ordered by the SECOND column
    assert not np.isnan(a[order][:2]).any()
    assert np.isnan(a[order][2:]).all()
    np.testing.assert_array_equal(b[order][2:], [0, 1, 2])


def test_composite_non_native_byte_order():
    """Big-endian storage (network/file formats) must byteswap before
    the sign-bit/total-order transforms, or signed/float lanes missort."""
    rng = np.random.default_rng(17)
    for dt in (">i4", ">f8", ">u4", ">i8", ">f4"):
        native = rng.integers(-1000, 1000, 500).astype(np.dtype(dt).newbyteorder("="))
        if np.dtype(dt).kind == "f":
            native = (native + rng.standard_normal(500)).astype(
                np.dtype(dt).newbyteorder("="))
        swapped = native.astype(dt)
        got = np.argsort(lex_composite((swapped,)), kind="stable")
        want = np.argsort(lex_composite((native,)), kind="stable")
        np.testing.assert_array_equal(got, want, err_msg=dt)
        np.testing.assert_array_equal(swapped[got],
                                      np.sort(native).astype(dt),
                                      err_msg=dt)


def test_composite_rejects_bad_input():
    with pytest.raises(ValueError):
        lex_composite(())
    with pytest.raises(ValueError):
        lex_composite((np.zeros(3), np.zeros(4)))
    with pytest.raises(ValueError):
        lex_composite((np.zeros((2, 2)),))
    with pytest.raises(TypeError):
        lex_composite((np.array(["a", "b"]),))


def test_sort_tuple_key_multifield(ctx, rng):
    """bof_sort with key returning a tuple: order by rounded magnitude,
    ties by signed value — a comparator no single column expresses."""
    n = 30_000
    data = (rng.standard_normal(n) * 4).astype(np.float32)
    src = mem_array((n,), np.float32, data=data, ctx=ctx)
    dst = mem_array((n,), np.float32, ctx=ctx)
    bof_sort(src, dst, key=lambda x: (np.round(np.abs(x)), x),
             blk_elems=3000, ctx=ctx)
    got = dst.read_all()
    order = np.lexsort((data, np.round(np.abs(data))))
    np.testing.assert_array_equal(got, data[order])


def test_sort_tuple_key_structured_records(ctx, rng):
    """The reference comparator's true analog: records sorted by one
    field, ties broken by another (flash::sort<T,Cmp>, sort.tpp:13)."""
    rec = np.dtype([("grp", np.int16), ("score", np.float32)])
    n = 20_000
    data = np.empty(n, rec)
    data["grp"] = rng.integers(-5, 5, n)
    data["score"] = rng.standard_normal(n).astype(np.float32)
    src = mem_array((n,), rec, data=data, ctx=ctx)
    dst = mem_array((n,), rec, ctx=ctx)
    bof_sort(src, dst, key=lambda r: (r["grp"], r["score"]),
             blk_elems=2500, ctx=ctx)
    got = dst.read_all()
    order = np.lexsort((data["score"], data["grp"]))
    np.testing.assert_array_equal(got, data[order])


def test_sort_arbitrary_cmp(ctx, rng):
    """cmp= is the reference comparator's full analog (flash::sort<T,Cmp>,
    sort.tpp:13): evens ascending before odds descending — a strict weak
    order with no single vectorized order-embedding."""
    from functools import cmp_to_key

    def cmp(a, b):
        a, b = int(a), int(b)
        ea, eb = a % 2 == 0, b % 2 == 0
        if ea != eb:
            return -1 if ea else 1
        return (a > b) - (a < b) if ea else (b > a) - (b < a)

    n = 25_000
    data = rng.integers(-900, 900, n).astype(np.int32)
    src = mem_array((n,), np.int32, data=data.copy(), ctx=ctx)
    dst = mem_array((n,), np.int32, ctx=ctx)
    bof_sort(src, dst, cmp=cmp, blk_elems=3000, ctx=ctx)
    want = np.array(sorted(data.tolist(), key=cmp_to_key(cmp)), np.int32)
    np.testing.assert_array_equal(dst.read_all(), want)
    # descending reverses the ascending comparator order
    dst2 = mem_array((n,), np.int32, ctx=ctx)
    bof_sort(src, dst2, cmp=cmp, descending=True, blk_elems=3000, ctx=ctx)
    np.testing.assert_array_equal(dst2.read_all(), want[::-1])


def test_sort_cmp_is_stable(ctx, rng):
    """Ascending cmp sort preserves input order among equal-comparing
    records (python sorted() golden, which is stable by spec)."""
    rec = np.dtype([("k", np.int8), ("tag", np.int32)])
    n = 9_000
    data = np.empty(n, rec)
    data["k"] = rng.integers(0, 4, n)          # duplicate-heavy keys
    data["tag"] = np.arange(n, dtype=np.int32)  # input-position tracer

    def cmp(a, b):  # compares ONLY field 0 — ties decided by stability
        return int(a[0]) - int(b[0])

    src = mem_array((n,), rec, data=data, ctx=ctx)
    dst = mem_array((n,), rec, ctx=ctx)
    bof_sort(src, dst, cmp=cmp, blk_elems=1024, ctx=ctx)
    got = dst.read_all()
    from functools import cmp_to_key
    want = np.array(sorted(data, key=cmp_to_key(cmp)), rec)
    np.testing.assert_array_equal(got, want)


def test_sort_cmp_key_mutually_exclusive(ctx, rng):
    n = 256
    src = mem_array((n,), np.int32,
                    data=rng.integers(0, 9, n).astype(np.int32), ctx=ctx)
    dst = mem_array((n,), np.int32, ctx=ctx)
    with pytest.raises(ValueError, match="not both"):
        bof_sort(src, dst, key=lambda x: x,
                 cmp=lambda a, b: int(a) - int(b), ctx=ctx)


def test_sort_tuple_key_descending(ctx, rng):
    n = 12_000
    data = rng.integers(0, 40, n).astype(np.int32)
    sec = rng.standard_normal(n).astype(np.float32)
    # store the pair as a record so the secondary travels with the value
    rec = np.dtype([("a", np.int32), ("b", np.float32)])
    packed = np.empty(n, rec)
    packed["a"], packed["b"] = data, sec
    src = mem_array((n,), rec, data=packed, ctx=ctx)
    dst = mem_array((n,), rec, ctx=ctx)
    bof_sort(src, dst, key=lambda r: (r["a"], r["b"]), descending=True,
             blk_elems=1500, ctx=ctx)
    got = dst.read_all()
    order = np.lexsort((packed["b"], packed["a"]))[::-1]
    np.testing.assert_array_equal(got, packed[order])
