"""The sparse layer's one band path (`bof_tpu_torch/sparse/spmm_device.py`:
`band_plan`, `build_band`, `ell_bands`, `upload_band`), which csrmm,
csrgemv, csrmm_sharded, xml_rank and the eigensolver all band through.

The bands are held bit for bit against bof_tpu's own composition of the
same pieces (`ell_row_ranges` over the count-sorted rows, `to_ell_rows`,
`quantize_ell_i8`), on a skewed block with a mega-row and empty rows, in
each value type that crosses the link (fp32, bf16 bits, int8 with a scale
a row), with rows sorted and not.  `upload_band` must send exactly the
bytes it books, for a whole band, a run of its rows, and without its row
selection; and each sparse entry must book, on one tiny call, the upload
bytes it booked before the band path was shared (pinned below).
"""
import os
import types

import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bof_tpu.sparse import spmm_device as ref_sdev
import bof_tpu_torch
from bof_tpu_torch.sparse import spmm_device as sdev
from bof_tpu_torch.utils import METRICS

BF16 = np.dtype(ml_dtypes.bfloat16)
CAP = 1 << 12
CPU = torch.device("cpu")
VKINDS = ["f32", "bf16", "int8"]


def _skewed_block(seed=3, rows=700, k=60000):
    """A CSR row block, offsets from 0: Poisson rows, a third of them
    empty, one mega-row that needs a band of its own under CAP and one
    long row."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(12, rows)
    counts[rng.permutation(rows)[:rows // 3]] = 0
    counts[17], counts[400] = 3000, 700
    ia = np.zeros(rows + 1, np.int64)
    np.cumsum(counts, out=ia[1:])
    ja = rng.integers(0, k, int(ia[-1])).astype(np.int64)
    va = rng.standard_normal(int(ia[-1])).astype(np.float32)
    return ia, ja, va


def _reference_bands(ia, ja, va, vkind, sort_rows, idt):
    """bof_tpu's composition: [(rows, counts, ja, va)] with va as the port
    carries it (bf16 as its np.uint16 bits, int8 as (values, scales))."""
    counts = np.diff(ia)
    order = (np.argsort(counts, kind="stable") if sort_rows
             else np.arange(len(counts)))
    bands = []
    for s0, s1 in ref_sdev.ell_row_ranges(counts[order], CAP):
        sel = order[s0:s1]
        ja_e, va_e = ref_sdev.to_ell_rows(
            ia, ja, va, sel, idx_dtype=idt,
            val_dtype=BF16 if vkind == "bf16" else None, counts=counts)
        if vkind == "bf16":
            va_e = va_e.view(np.uint16)
        elif vkind == "int8":
            va_e = ref_sdev.quantize_ell_i8(va_e)
        bands.append((sel, counts[sel], ja_e, va_e))
    return bands


def _port_bands(ia, ja, va, vkind, sort_rows, idt):
    counts = np.diff(ia)
    order, ranges = sdev.band_plan(counts, CAP, sort_rows)
    return [sdev.build_band(ia, ja, va, order[s0:s1], counts, idt,
                            np.uint16 if vkind == "bf16" else None,
                            quantize=vkind == "int8")
            for s0, s1 in ranges]


def _equal_vals(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sort_rows", [True, False])
@pytest.mark.parametrize("vkind", VKINDS)
@pytest.mark.parametrize("idt", [np.uint16, np.int32])
def test_bands_are_the_references_composition(vkind, sort_rows, idt):
    ia, ja, va = _skewed_block()
    want = _reference_bands(ia, ja, va, vkind, sort_rows, idt)
    got = _port_bands(ia, ja, va, vkind, sort_rows, idt)
    assert len(got) == len(want) > 2
    for band, (sel, cnt, ja_e, va_e) in zip(got, want):
        assert band.rows.dtype == band.counts.dtype == np.int32
        np.testing.assert_array_equal(band.rows, sel)
        np.testing.assert_array_equal(band.counts, cnt)
        assert band.ja.dtype == ja_e.dtype == np.dtype(idt)
        np.testing.assert_array_equal(band.ja, ja_e)
        _equal_vals(band.va, va_e)
    # the bands partition the block's rows; the mega-row is alone
    rows = np.concatenate([b.rows for b in got])
    np.testing.assert_array_equal(np.sort(rows), np.arange(len(ia) - 1))
    assert any(b.rows.tolist() == [17] for b in got)
    # ell_bands, the whole block at once, is the same list
    cfg = types.SimpleNamespace(ell_sort_rows=sort_rows)
    whole = sdev.ell_bands(ia, ja, va, CAP, cfg, idt,
                           np.uint16 if vkind == "bf16" else None,
                           quantize=vkind == "int8")
    for a, b in zip(whole, got):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.ja, b.ja)
        _equal_vals(a.va, b.va)


def _host_vals(va, lo, hi):
    return (va[0][lo:hi], va[1][lo:hi]) if isinstance(va, tuple) \
        else va[lo:hi]


@pytest.mark.parametrize("run", ["whole", "rows_lo_hi", "no_rows"])
@pytest.mark.parametrize("vkind", VKINDS)
def test_upload_band_sends_the_bytes_it_books(vkind, run):
    """rows [lo, hi) of each band, padding rows included where the run
    reaches them, cross the link as they stand, and `nbytes` and the
    `h2d.bytes` counter both count exactly what went up."""
    ia, ja, va = _skewed_block(seed=5)
    for band in _port_bands(ia, ja, va, vkind, True, np.uint16):
        n = len(band.rows)
        lo, hi = {"whole": (0, None), "rows_lo_hi": (n // 3, n - n // 4),
                  "no_rows": (1, n)}[run]
        before = METRICS.get("h2d.bytes")
        up = sdev.upload_band(band, CPU, lo, hi, with_rows=run != "no_rows")
        vals = _host_vals(band.va, lo, hi)
        parts = [band.counts[lo:hi], band.ja[lo:hi]]
        parts += list(vals) if isinstance(vals, tuple) else [vals]
        if run == "no_rows":
            assert up.rows is None
        else:
            parts.append(band.rows[lo:hi])
            np.testing.assert_array_equal(up.rows.numpy(), band.rows[lo:hi])
        assert up.nbytes == sum(p.nbytes for p in parts)
        assert METRICS.get("h2d.bytes") - before == up.nbytes
        if run == "whole":
            assert up.ja.shape[0] == band.ja.shape[0]  # padding rows too
        np.testing.assert_array_equal(up.counts.numpy(), band.counts[lo:hi])
        np.testing.assert_array_equal(up.ja.numpy(), band.ja[lo:hi])
        if vkind == "int8":
            np.testing.assert_array_equal(up.va.numpy(), vals[0])
            np.testing.assert_array_equal(up.va_scale.numpy(), vals[1])
        else:
            assert up.va_scale is None
            got = (up.va.view(torch.int16).numpy().view(np.uint16)
                   if vkind == "bf16" else up.va.numpy())
            np.testing.assert_array_equal(got, vals)


# --------------------------- each entry's upload bytes on one tiny call

# <entry>.h2d_bytes of one call (A 500 x 3000 at density 0.01, seed 11;
# csrmm B 3000 x 40, xml W 150 x 3000, panels of 64 labels, top 5),
# as every entry booked them before the band path was shared
PINNED = {
    ("csrmm", "float32"): 1151552,
    ("csrmm", "bfloat16"): 930368,
    ("csrmm", "int8"): 826688,
    ("csrgemv", "float32"): 347776,
    ("csrgemv", "bfloat16"): 237184,
    ("csrgemv", "int8"): 185344,
    ("xml_rank", "float32"): 2382768,
}
M, VOCAB, COLS, LABELS = 500, 3000, 40, 150


def _entry_call(tmp_path, entry, xfer):
    """One call of `entry` on the CPU, returning (its <entry>.h2d_bytes,
    the call's h2d.bytes)."""
    a_sp = sps.random(M, VOCAB, density=0.01, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(11))
    a_sp.data[:] = np.random.default_rng(11).standard_normal(a_sp.nnz)
    cfg = bof_tpu_torch.FlashConfig(
        device="cpu", scratch_dir=str(tmp_path / "scratch"),
        program_budget=64 << 20, max_nnzs=1024, csrmm_cblk_size=32,
        transfer_dtype=xfer)
    ctx = bof_tpu_torch.FlashContext(cfg)
    rng = np.random.default_rng(12)
    key = entry + ".h2d_bytes"
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        if entry == "csrgemv":
            x = rng.standard_normal(VOCAB).astype(np.float32)
            m0 = METRICS.snapshot()
            bof_tpu_torch.csrgemv(a, x, ctx=ctx)
        elif entry == "csrmm":
            b = bof_tpu_torch.mem_array((VOCAB, COLS), np.float32, ctx=ctx)
            b.write_all(rng.standard_normal((VOCAB, COLS)).astype(np.float32))
            c = bof_tpu_torch.mem_array((M, COLS), np.float32, ctx=ctx)
            m0 = METRICS.snapshot()
            bof_tpu_torch.csrmm(a, b, c, ctx=ctx)
        else:
            path = os.path.join(str(tmp_path), "W")
            rng.standard_normal((LABELS, VOCAB)).astype(np.float32).tofile(
                path)
            w = bof_tpu_torch.map_array(path, (LABELS, VOCAB), np.float32,
                                        ctx=ctx)
            m0 = METRICS.snapshot()
            bof_tpu_torch.xml_rank(a, w, 5, label_blk=64, fused=True,
                                   ctx=ctx)
        m1 = METRICS.snapshot()
    finally:
        ctx.destroy()
    return (m1.get(key, 0) - m0.get(key, 0),
            m1.get("h2d.bytes", 0) - m0.get("h2d.bytes", 0))


@pytest.mark.parametrize("entry,xfer", list(PINNED))
def test_entries_book_the_upload_bytes_they_booked_before(tmp_path, entry,
                                                          xfer):
    booked, sent = _entry_call(tmp_path, entry, xfer)
    assert booked == PINNED[(entry, xfer)]
    assert sent == booked  # every upload of the call is booked


def _counts_of(kind, rng):
    """Row counts of one kind: small, Zipf-skewed, wide (past 16 bits),
    empty rows with a few mega-rows, none at all."""
    n = int(rng.integers(1, 3000))
    if kind == "small":
        return rng.integers(0, 5, n)
    if kind == "zipf":
        return rng.zipf(1.3, n).clip(0, 1 << 20)
    if kind == "wide":
        return rng.integers(0, 1 << 18, n)
    if kind == "mega":
        c = np.zeros(n, np.int64)
        c[rng.permutation(n)[:3]] = rng.integers(1 << 12, 1 << 16, 3)
        return c
    return np.zeros(0, np.int64)


@pytest.mark.parametrize("kind", ["small", "zipf", "wide", "mega", "none"])
def test_band_plan_is_ell_row_ranges_on_sorted_rows(kind):
    """`band_plan`'s numpy planner (every sorted caller's: csrgemv,
    csrmm, xml_rank and the eigensolver's hundreds of thousands of words
    a band) gives the stable count order and bof_tpu's `ell_row_ranges`
    over the count-sorted rows, range for range, on caps from below a
    row to past every row; unsorted, the identity and the scan."""
    rng = np.random.default_rng(["small", "zipf", "wide", "mega",
                                 "none"].index(kind))
    for _ in range(40):
        counts = _counts_of(kind, rng)
        for cap in (1, 3, 64, 1000, CAP, 1 << 20, 2_684_354):
            order, ranges = sdev.band_plan(counts, cap)
            np.testing.assert_array_equal(
                order, np.argsort(counts, kind="stable"))
            assert ranges == ref_sdev.ell_row_ranges(counts[order], cap)
            order, ranges = sdev.band_plan(counts, cap, sort_rows=False)
            np.testing.assert_array_equal(order, np.arange(len(counts)))
            assert ranges == ref_sdev.ell_row_ranges(counts, cap)
