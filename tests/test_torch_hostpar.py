"""The port's host phase-body fan-out (`bof_tpu_torch/utils/hostpar.py`)
and its engine's run merge and counting argsort, against numpy and
against bof_tpu's copies, bit for bit, on the CPU.

Every case of tests/test_hostpar.py runs here on the port's modules, but
the fp64 plane fold: the port leaves `bof_fold_i32_f64` unbound (it served
only bof_tpu's Ozaki emulation), which the last case pins.  As there,
BOF_HOST_THREADS forces the sharded multi-thread paths (shard sort +
pairwise merges, per-thread histograms + stable scatter, chunked apply).
"""
import ctypes
import dataclasses

import numpy as np
import pytest

import bof_tpu
import bof_tpu_torch
from bof_tpu.utils import hostpar as ref_hostpar
from bof_tpu_torch.io.native import (counting_argsort_i32, load_library,
                                     merge_sorted_runs)
from bof_tpu_torch.utils.hostpar import (fanout_threads, parallel_map_chunks,
                                         parallel_sort)

pytestmark = pytest.mark.skipif(load_library() is None,
                                reason="native engine unavailable")


@pytest.fixture
def port_ctx(ctx):
    """The port's context on the CPU, configured as the reference tests'
    `ctx`, in a scratch directory of its own."""
    c = bof_tpu_torch.FlashContext(bof_tpu_torch.config_from_reference(
        dataclasses.asdict(ctx.config), device="cpu",
        scratch_dir=ctx.config.scratch_dir + "_port"))
    yield c
    c.destroy()


@pytest.fixture
def forced_threads(monkeypatch):
    monkeypatch.setenv("BOF_HOST_THREADS", "7")  # odd: lone-tail merges


@pytest.mark.parametrize("dt", [np.float32, np.float64, np.int64,
                                np.uint64, np.int32, np.uint32,
                                np.int16, np.uint16, np.int8, np.uint8])
def test_parallel_sort_matches_numpy(forced_threads, dt):
    rng = np.random.default_rng(1)
    n = 100_003  # prime: ragged shard bounds
    if np.dtype(dt).kind == "f":
        x = rng.standard_normal(n).astype(dt)
    else:
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, dtype=dt,
                         endpoint=True)
    want = np.sort(x)
    ref = x.copy()
    ref_hostpar.parallel_sort(ref)
    parallel_sort(x)
    np.testing.assert_array_equal(x, want)
    np.testing.assert_array_equal(x.view(np.uint8), ref.view(np.uint8))


def test_parallel_sort_nan_last(forced_threads):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(65_537).astype(np.float32)
    x[rng.choice(len(x), 1000, replace=False)] = np.nan
    want = np.sort(x)  # numpy: NaNs last
    parallel_sort(x)
    assert np.isnan(x[-1000:]).all()
    np.testing.assert_array_equal(x[:-1000], want[:-1000])


def test_parallel_sort_single_thread(monkeypatch):
    monkeypatch.setenv("BOF_HOST_THREADS", "1")
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    want = np.sort(x)
    parallel_sort(x)
    np.testing.assert_array_equal(x, want)


def test_merge_sorted_runs_direct(forced_threads):
    # merge layer alone: 5 ragged pre-sorted runs, incl. an empty one
    rng = np.random.default_rng(4)
    bounds = np.array([0, 1000, 1000, 33_000, 60_000, 100_001], np.int64)
    x = rng.standard_normal(100_001).astype(np.float64)
    want = np.sort(x.copy())
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        x[lo:hi].sort()
    assert merge_sorted_runs(x, bounds) is True
    np.testing.assert_array_equal(x, want)


def test_merge_sorted_runs_rejects_bad_bounds():
    x = np.zeros(16, np.float32)
    with pytest.raises(ValueError):
        merge_sorted_runs(x, np.array([0, 4, 3, 16], np.int64))
    with pytest.raises(ValueError):
        merge_sorted_runs(x, np.array([0, 8], np.int64))  # b[-1] != n
    assert merge_sorted_runs(np.zeros(8, np.complex64),
                             np.array([0, 4, 8], np.int64)) is False


def test_counting_argsort_stable(forced_threads):
    rng = np.random.default_rng(5)
    k = 97
    keys = rng.integers(0, k, 50_001).astype(np.int32)
    got = counting_argsort_i32(keys, k)
    assert got is not None
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got, want)


def test_counting_argsort_edges(forced_threads):
    # empty
    got = counting_argsort_i32(np.zeros(0, np.int32), 4)
    assert got is not None and got.size == 0
    # out-of-range key: engine refuses, caller falls back
    assert counting_argsort_i32(np.array([0, 5], np.int32), 4) is None
    # k too large for the histogram: refuse
    assert counting_argsort_i32(np.array([0], np.int32), 1 << 23) is None
    # single key value
    keys = np.zeros(10_000, np.int32)
    got = counting_argsort_i32(keys, 1)
    np.testing.assert_array_equal(got, np.arange(10_000))


def test_parallel_map_chunks(forced_threads, monkeypatch):
    # value-wise fn over ragged chunk bounds == the serial apply
    monkeypatch.setenv("BOF_HOST_THREADS", "5")
    x = np.random.default_rng(7).standard_normal(1 << 20) * 1e3
    got = parallel_map_chunks(lambda v: np.sqrt(np.abs(v)), x)
    np.testing.assert_array_equal(got, np.sqrt(np.abs(x)))
    assert got.dtype == x.dtype


def test_parallel_map_chunks_error_propagates(monkeypatch):
    monkeypatch.setenv("BOF_HOST_THREADS", "4")

    def bad(v):
        raise ValueError("boom")
    with pytest.raises(ValueError, match="boom"):
        parallel_map_chunks(bad, np.zeros(1 << 20, np.float32))


def test_fanout_threads_bounds(monkeypatch):
    monkeypatch.delenv("BOF_HOST_THREADS", raising=False)
    assert fanout_threads(100) == 1  # tiny body stays serial
    monkeypatch.setenv("BOF_HOST_THREADS", "99")
    assert fanout_threads(1 << 24) == 16  # override is capped
    # the override BYPASSES the min_per amortization floor — otherwise
    # every forced-fanout test in this file with n < 2*min_per would
    # silently run the serial path and never reach the merge kernels
    monkeypatch.setenv("BOF_HOST_THREADS", "7")
    assert fanout_threads(100_003) == 7
    assert fanout_threads(3) == 3  # hard one-element-per-shard bound


def test_bof_sort_forced_fanout(forced_threads, port_ctx, ctx, rng):
    """End-to-end sample sort with every host block sort sharded, bit for
    bit bof_tpu's."""
    n = 200_000
    data = rng.standard_normal(n).astype(np.float32)
    outs = []
    for bt, c in ((bof_tpu, ctx), (bof_tpu_torch, port_ctx)):
        src = bt.mem_array((n,), np.float32, data=data, ctx=c)
        dst = bt.mem_array((n,), np.float32, ctx=c)
        bt.bof_sort(src, dst, blk_elems=30_000, ctx=c)
        outs.append(dst.read_all())
    np.testing.assert_array_equal(outs[1], np.sort(data))
    np.testing.assert_array_equal(outs[1].view(np.uint32),
                                  outs[0].view(np.uint32))


def test_csrcsc_forced_fanout(forced_threads, port_ctx):
    """csrcsc phase-2 merge with the native counting argsort sharded."""
    import scipy.sparse as sps

    from bof_tpu_torch import CsrFlashMatrix, csrcsc_scratch
    a = sps.random(3000, 500, density=0.02, format="csr",
                   dtype=np.float32, random_state=np.random.RandomState(9))
    A = CsrFlashMatrix.from_scipy(a, ctx=port_ctx)
    AT = csrcsc_scratch(A, ctx=port_ctx)
    want = a.T.tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(AT.read_ia(), want.indptr)
    np.testing.assert_array_equal(AT.ja.read_all(), want.indices)
    np.testing.assert_allclose(AT.vals.read_all(), want.data, rtol=1e-6)


def test_fp64_slicing_helpers_stay_unbound():
    """bof_tpu's engine binds the Ozaki slice/fold pair; the port's copy of
    the engine has them, but io/native.py binds neither (K1's fp64
    variant replaced the emulation they served), while the run merge is
    bound and keeps bof_tpu's dtype table."""
    from bof_tpu.io import native as ref_native
    from bof_tpu_torch.io import native
    assert not hasattr(native, "split_f64_i8")
    assert not hasattr(native, "fold_i32_f64")
    assert native._SORT_KINDS == ref_native._SORT_KINDS
    lib = load_library()
    assert lib.bof_merge_sorted_runs.restype is ctypes.c_int
