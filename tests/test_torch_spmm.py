"""The port's ELL kernels' plain versions and host ELL prep, held against
bof_tpu's Pallas ELL SpMM (interpret mode) and its XLA steps.

`spmm_ell` / `spmv_ell` (bof_tpu_torch/sparse/spmm_cuda.py) take their
plain versions on CPU tensors; the CUDA kernels themselves run only on a
card (tests/test_torch_cuda.py).  Inputs are CSR blocks made from a
seeded numpy generator and converted to ELL by each package's own
`to_ell`.  Tolerance rtol 1e-5, atol 1e-5, as tests/test_pallas.py
(fp32 sums of at most a few hundred terms in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bof_tpu.sparse import spmm_device as ref_sdev
from bof_tpu.sparse.spmm_pallas import spmm_ell_pallas
from bof_tpu_torch.sparse import spmm_device as port_sdev
from bof_tpu_torch.sparse.spmm_cuda import (spmm_ell, spmm_ell_ref, spmv_ell,
                                            spmv_ell_ref)

TOL = dict(rtol=1e-5, atol=1e-5)


def _random_csr(rng, rows, k, max_nnz_per_row, mega=()):
    counts = rng.integers(0, max_nnz_per_row + 1, rows)
    for r, c in mega:
        counts[r] = c
    ia = np.zeros(rows + 1, np.int64)
    np.cumsum(counts, out=ia[1:])
    nnz = int(ia[-1])
    ja = rng.integers(0, k, nnz, dtype=np.int64)
    va = rng.standard_normal(nnz).astype(np.float32)
    return ia, ja, va


def _both_ell(ia, ja, va, idx_dtype=np.int32):
    """Each package's ELL of one block; they must be identical."""
    want = ref_sdev.to_ell(ia, ja, va, idx_dtype=idx_dtype)
    got = port_sdev.to_ell(ia, ja, va, idx_dtype=idx_dtype)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("rows,k,cb,mr", [(64, 256, 128, 20),
                                          (24, 128, 128, 3),
                                          (16, 128, 256, 1)])
def test_spmm_plain_matches_pallas_interpret(rng, rows, k, cb, mr):
    """tests/test_pallas.py's shapes: padding rows and slots, rmax 1-32."""
    ja_ell, va_ell = _both_ell(*_random_csr(rng, rows, k, mr))
    b = rng.standard_normal((k, cb)).astype(np.float32)
    want = np.asarray(spmm_ell_pallas(jnp.asarray(b), jnp.asarray(ja_ell),
                                      jnp.asarray(va_ell), interpret=True))
    got = spmm_ell(torch.from_numpy(b), torch.from_numpy(ja_ell),
                   torch.from_numpy(va_ell))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", ["ragged_cb", "uint16", "padding",
                                  "mega_row"])
def test_spmm_plain_matches_xla_block(rng, case):
    """Against bof_tpu's XLA body (spmm_ell_block) where the Pallas kernel
    cannot go: cb not a multiple of 128, uint16 indices, rows padded
    past the block, a mega-row with a band of its own."""
    rows, k, cb, mr, mega, idt = 24, 300, 37, 9, (), np.int32
    if case == "uint16":
        k, idt = 65536, np.uint16
    elif case == "padding":
        rows, mr = 13, 2  # rows_pad 16, most slots padding
    elif case == "mega_row":
        rows, cb, mega = 8, 64, ((3, 1500),)
    ia, ja, va = _random_csr(rng, rows, k, mr, mega)
    if case == "uint16":
        ja[0] = 65535  # the top index must survive the narrow type
    ja_ell, va_ell = _both_ell(ia, ja, va, idx_dtype=idt)
    assert ja_ell.dtype == idt
    b = rng.standard_normal((k, cb)).astype(np.float32)
    want = np.asarray(ref_sdev.spmm_ell_block(b, ja_ell, va_ell))
    got = port_sdev.spmm_ell_block(torch.from_numpy(b),
                                   torch.from_numpy(ja_ell),
                                   torch.from_numpy(va_ell))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("idt", [np.int32, np.uint16])
def test_spmv_plain_matches_xla_block(rng, idt):
    ia, ja, va = _random_csr(rng, 200, 5000, 40, mega=((7, 700),))
    ja_ell, va_ell = _both_ell(ia, ja, va, idx_dtype=idt)
    x = rng.standard_normal(5000).astype(np.float32)
    want = np.asarray(ref_sdev.spmv_ell_block(x, ja_ell, va_ell))
    got = port_sdev.spmv_ell_block(torch.from_numpy(x),
                                   torch.from_numpy(ja_ell),
                                   torch.from_numpy(va_ell))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing(rng):
    ja_ell, va_ell = port_sdev.to_ell(*_random_csr(rng, 10, 50, 4))
    b = torch.from_numpy(rng.standard_normal((50, 8), dtype=np.float32))
    ja_t, va_t = torch.from_numpy(ja_ell), torch.from_numpy(va_ell)
    before = spmm_ell.launches, spmv_ell.launches
    torch.testing.assert_close(spmm_ell(b, ja_t, va_t),
                               spmm_ell_ref(b, ja_t, va_t))
    x = b[:, 0].contiguous()
    torch.testing.assert_close(spmv_ell(x, ja_t, va_t),
                               spmv_ell_ref(x, ja_t, va_t))
    assert (spmm_ell.launches, spmv_ell.launches) == before


@pytest.mark.parametrize("bad", ["ja_int64", "va_f64", "shape", "contig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b = torch.zeros(20, 8)
    ja = torch.zeros(4, 3, dtype=torch.int32)
    va = torch.zeros(4, 3)
    err = ValueError
    if bad == "ja_int64":
        ja, err = ja.long(), TypeError
    elif bad == "va_f64":
        va, err = va.double(), TypeError
    elif bad == "shape":
        va = torch.zeros(4, 2)
    else:
        b = torch.zeros(8, 20).T
    with pytest.raises(err):
        spmm_ell(b, ja, va)


@pytest.mark.parametrize("impl", ["xla", "pallas", "auto"])
def test_dispatch_takes_every_reference_impl(rng, impl):
    ja_ell, va_ell = port_sdev.to_ell(*_random_csr(rng, 16, 64, 5))
    b = rng.standard_normal((64, 16)).astype(np.float32)
    want = np.asarray(ref_sdev.spmm_ell_block_dispatch(b, ja_ell, va_ell,
                                                       impl=impl))
    got = port_sdev.spmm_ell_block_dispatch(
        torch.from_numpy(b), torch.from_numpy(ja_ell),
        torch.from_numpy(va_ell), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="sparse_device_impl"):
        port_sdev.spmm_ell_block_dispatch(
            torch.from_numpy(b), torch.from_numpy(ja_ell),
            torch.from_numpy(va_ell), impl="triton")


@pytest.mark.parametrize("entry_cap", [1 << 8, 1 << 12, 1 << 17])
def test_banding_is_the_reference_banding(rng, entry_cap):
    """Row ranges, ELL dims and index dtypes decide the bands (and K2's
    launch count): the port must form exactly bof_tpu's."""
    counts = np.concatenate([rng.poisson(20, 3000), [0, 0, 4000, 900]])
    for ordered in (counts, np.sort(counts, kind="stable")):
        ranges = port_sdev.ell_row_ranges(ordered, entry_cap)
        assert ranges == ref_sdev.ell_row_ranges(ordered, entry_cap)
        for s0, s1 in ranges:
            assert (port_sdev.ell_dims(ordered[s0:s1])
                    == ref_sdev.ell_dims(ordered[s0:s1]))
    for kp in (0, 1, 65536, 65537, 1 << 20):
        for narrow in (True, False):
            assert (port_sdev.ell_idx_dtype(kp, narrow)
                    == ref_sdev.ell_idx_dtype(kp, narrow))


def test_to_ell_rows_matches_reference(rng):
    ia, ja, va = _random_csr(rng, 300, 70000, 30, mega=((5, 400),))
    counts = np.diff(ia)
    order = np.argsort(counts, kind="stable")
    for s0, s1 in ref_sdev.ell_row_ranges(counts[order], 1 << 12):
        sel = order[s0:s1]
        want = ref_sdev.to_ell_rows(ia, ja, va, sel, idx_dtype=np.uint16,
                                    counts=counts)
        got = port_sdev.to_ell_rows(ia, ja, va, sel, idx_dtype=np.uint16,
                                    counts=counts)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------- the in-place contract

SENTINEL = -3.75
BAND_CASES = ["int32", "uint16", "ragged_cb", "zero_rows", "mega_row",
              "unsorted"]


def _band_case(rng, case):
    """One seeded CSR block and how it is banded: (ia, ja, va, k, cb,
    index dtype, sort rows, entry_cap)."""
    rows, k, cb, mr, mega, idt, sort_rows, cap = (300, 500, 64, 12, (),
                                                  np.int32, True, 1 << 10)
    if case == "uint16":
        k, idt = 65536, np.uint16
    elif case == "ragged_cb":
        cb = 37
    elif case == "zero_rows":
        mr = 2  # a third of the rows empty
    elif case == "mega_row":
        mega = ((7, 1500), (150, 900))  # bands of their own under the cap
    elif case == "unsorted":
        sort_rows = False
    ia, ja, va = _random_csr(rng, rows, k, mr, mega)
    if case == "uint16":
        ja[0] = 65535
    return ia, ja, va, k, cb, idt, sort_rows, cap


def _bands(ia, ja, va, idt, sort_rows, cap):
    """Each band as both packages form it: (block rows, counts, ELL)."""
    counts = np.diff(ia)
    order = (np.argsort(counts, kind="stable") if sort_rows
             else np.arange(len(counts)))
    ranges = port_sdev.ell_row_ranges(counts[order], cap)
    assert ranges == ref_sdev.ell_row_ranges(counts[order], cap)
    for s0, s1 in ranges:
        sel = order[s0:s1]
        want = ref_sdev.to_ell_rows(ia, ja, va, sel, idx_dtype=idt,
                                    counts=counts)
        got = port_sdev.to_ell_rows(ia, ja, va, sel, idx_dtype=idt,
                                    counts=counts)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        yield sel, counts[sel], got


def _placed(rng, rows, width):
    """Block row r lands at dest[r] of an out with 7 more rows, filled
    with the sentinel; returns (dest, out, rows no band names)."""
    total = rows + 7
    perm = rng.permutation(total)
    return perm[:rows], np.full((total,) + width, SENTINEL, np.float32), \
        perm[rows:]


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("case", BAND_CASES)
def test_spmm_contract_bands_match_reference(rng, case, alpha):
    """Each band of a block through the port's plain K2 with counts, a
    permuted rows into a sentinel-filled out and alpha, against bof_tpu's
    XLA body on the same band, scattered and scaled in numpy."""
    ia, ja, va, k, cb, idt, sort_rows, cap = _band_case(rng, case)
    b = rng.standard_normal((k, cb)).astype(np.float32)
    dest, want, untouched = _placed(rng, len(ia) - 1, (cb,))
    got = torch.from_numpy(want.copy())
    for sel, cnt, (ja_ell, va_ell) in _bands(ia, ja, va, idt, sort_rows,
                                             cap):
        band = np.asarray(ref_sdev.spmm_ell_block(b, ja_ell, va_ell))
        want[dest[sel]] = alpha * band[:len(sel)]
        out = spmm_ell(torch.from_numpy(b), torch.from_numpy(ja_ell),
                       torch.from_numpy(va_ell),
                       counts=torch.from_numpy(cnt.astype(np.int32)),
                       rows=torch.from_numpy(dest[sel].astype(np.int32)),
                       out=got, alpha=alpha)
        assert out is got
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got.numpy()[untouched] == SENTINEL).all()


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("case", BAND_CASES)
def test_spmv_contract_bands_match_reference(rng, case, alpha):
    """The SpMV's plain version under the same contract against bof_tpu's
    spmv_ell_block."""
    ia, ja, va, k, _, idt, sort_rows, cap = _band_case(rng, case)
    x = rng.standard_normal(k).astype(np.float32)
    dest, want, untouched = _placed(rng, len(ia) - 1, ())
    got = torch.from_numpy(want.copy())
    for sel, cnt, (ja_ell, va_ell) in _bands(ia, ja, va, idt, sort_rows,
                                             cap):
        band = np.asarray(ref_sdev.spmv_ell_block(x, ja_ell, va_ell))
        want[dest[sel]] = alpha * band[:len(sel)]
        spmv_ell(torch.from_numpy(x), torch.from_numpy(ja_ell),
                 torch.from_numpy(va_ell),
                 counts=torch.from_numpy(cnt.astype(np.int32)),
                 rows=torch.from_numpy(dest[sel].astype(np.int32)),
                 out=got, alpha=alpha)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got.numpy()[untouched] == SENTINEL).all()


def test_padding_slots_are_never_read(rng):
    """Slots past counts may hold any index and value: the plain versions
    return what they return with the padding zeroed."""
    ja_ell, va_ell = port_sdev.to_ell(*_random_csr(rng, 20, 40, 6))
    counts = torch.from_numpy(
        np.count_nonzero(va_ell, axis=1).astype(np.int32))
    ja_t, va_t = torch.from_numpy(ja_ell), torch.from_numpy(va_ell)
    pad = torch.arange(ja_t.shape[1])[None, :] >= counts[:, None].long()
    bad_ja = torch.where(pad, 10 ** 6, ja_t.long()).to(torch.int32)
    bad_va = torch.where(pad, float("nan"), va_t)
    b = torch.from_numpy(rng.standard_normal((40, 9), dtype=np.float32))
    torch.testing.assert_close(
        spmm_ell(b, bad_ja, bad_va, counts=counts),
        spmm_ell(b, ja_t, va_t))
    x = b[:, 0].contiguous()
    torch.testing.assert_close(spmv_ell(x, bad_ja, bad_va, counts=counts),
                               spmv_ell(x, ja_t, va_t))


def test_non_finite_b_row_0_stays_out_of_padded_rows(rng):
    """The deliberate difference from the reference's padding workaround:
    bof_tpu multiplies padding slots (ja 0, va 0) like real ones, so an
    Inf in B row 0 turns every padded row into NaN; the port skips
    padding, as the scipy golden model does."""
    import scipy.sparse as sps
    ia, ja, va = _random_csr(rng, 16, 30, 5)
    ja[ja == 0] = 1  # no real slot reads row 0
    ja_ell, va_ell = port_sdev.to_ell(ia, ja, va)
    counts = np.diff(ia).astype(np.int32)
    b = rng.standard_normal((30, 4)).astype(np.float32)
    b[0] = np.inf
    got = spmm_ell(torch.from_numpy(b), torch.from_numpy(ja_ell),
                   torch.from_numpy(va_ell), counts=torch.from_numpy(counts),
                   rows=torch.arange(16, dtype=torch.int32),
                   out=torch.zeros(16, 4)).numpy()
    golden = sps.csr_matrix((va, ja, ia), shape=(16, 30)) @ b
    np.testing.assert_allclose(got, golden, **TOL)
    ref = np.asarray(ref_sdev.spmm_ell_block(b, ja_ell, va_ell))[:16]
    padded = counts < ja_ell.shape[1]
    assert np.isnan(ref[padded]).all() and np.isfinite(got).all()


@pytest.mark.parametrize("bad", ["rows_without_out", "counts_len",
                                 "rows_int64", "out_shape", "too_many_rows"])
def test_wrapper_rejects_what_the_contract_does_not_take(bad):
    b = torch.zeros(20, 8)
    ja = torch.zeros(4, 3, dtype=torch.int32)
    va = torch.zeros(4, 3)
    kw = dict(rows=torch.arange(4, dtype=torch.int32), out=torch.zeros(9, 8),
              counts=torch.ones(4, dtype=torch.int32))
    err = ValueError
    if bad == "rows_without_out":
        del kw["out"]
    elif bad == "counts_len":
        kw["counts"] = torch.ones(3, dtype=torch.int32)
    elif bad == "rows_int64":
        kw["rows"], err = torch.arange(4), TypeError
    elif bad == "out_shape":
        kw["out"] = torch.zeros(9, 7)
    else:
        kw["rows"] = torch.arange(5, dtype=torch.int32)
        kw["counts"] = torch.ones(5, dtype=torch.int32)
    with pytest.raises(err):
        spmm_ell(b, ja, va, **kw)
