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
