"""The rest of tests/test_fuzz.py against the port, with its case counts
(tests/test_torch_fuzz.py holds gemm and fp32 csrmm and the functions
that build the shared cases): float64 csrmm, xml_rank on both of its paths, the float64
Lloyd step and the parallel host sort, and the float64 gemm through the
port's sharded path.  Each case runs on both packages with the same
inputs and holds the port to float64 numpy/scipy within bof_tpu's
tolerance and to bof_tpu's own output (float64 within bof_tpu's 1e-12
scaled bound; the host paths bit for bit)."""
import functools

import numpy as np
import pytest
import scipy.sparse as sps

from test_torch_fuzz import _N, check_gemm64, csrmm_case, gemm_case
from torch_pair import BOTH, PORT, REF, engine


@pytest.fixture
def contexts(tmp_path):
    ctxs = {pk.name: pk.context(tmp_path / f"{pk.name}_scratch")
            for pk in BOTH}
    yield ctxs
    for c in ctxs.values():
        c.destroy()


@pytest.mark.parametrize("case", range(_N or 4))
def test_gemm64_sharded_fuzz(case, contexts):
    """The same float64 cases through the port's gemm64(mesh=) on a world
    of one gloo rank (`gemm_sharded`'s float64 path) against bof_tpu's
    sliced gemm64."""
    from torch_dist_pool import one_rank_world
    contexts[REF.name].config.fp64_device = "sliced"
    ref = gemm_case(REF, contexts[REF.name], 7000 + case, np.float64, 120,
                    [16, 32, 64], True)[0]
    with one_rank_world() as mesh:
        got = gemm_case(PORT, contexts[PORT.name], 7000 + case, np.float64,
                        120, [16, 32, 64], True,
                        gemm=functools.partial(PORT.bt.gemm64, mesh=mesh))
    check_gemm64(ref, *got)


@pytest.mark.parametrize("case", range(_N or 6))
def test_xml_rank_fuzz(case, contexts):
    """Random shapes, k and label blocks on both xml_rank paths against the
    dense top-k (order- and tie-robust: the scores are the sorted golden
    top-k, each label's true score its reported one) and against
    bof_tpu's scores."""
    def run(pk, ctx):
        rng = np.random.default_rng(3000 + case)
        docs = int(rng.integers(10, 300))
        vocab = int(rng.integers(8, 120))
        n_labels = int(rng.integers(3, 80))
        k = int(rng.integers(1, n_labels + 1))
        fused = bool(rng.integers(2))
        w_order = ("R", "C")[rng.integers(2)]
        label_blk = int(rng.integers(1, n_labels + 1))
        ctx.config.max_nnzs = int(rng.choice([128, 1024, 1 << 20]))
        a_sp = sps.random(docs, vocab,
                          density=float(rng.uniform(0.01, 0.2)),
                          format="csr", dtype=np.float32,
                          random_state=np.random.RandomState(case))
        w_np = rng.standard_normal((n_labels, vocab)).astype(np.float32)
        A = pk.bt.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        flash_empty = pk.mod("core.flash_array").flash_empty
        if w_order == "R":
            W = flash_empty((n_labels, vocab), np.float32, ctx=ctx)
            W.write_all(w_np)
        else:
            W = flash_empty((vocab, n_labels), np.float32, order="C",
                            ctx=ctx)
            W.write_all(w_np.T)
        s, lab = pk.mod("apps").xml_rank(A, W, k, label_blk=label_blk,
                                         fused=fused, ctx=ctx)
        tag = (f"case {case}: docs{docs} vocab{vocab} L{n_labels} k{k} "
               f"fused{fused} {w_order} lb{label_blk}")
        return (s.read_all(), lab.read_all(),
                (a_sp @ w_np.T).astype(np.float32), k, tag)
    (ref_s, _, _, _, _), (got_s, got_l, want, k, tag) = (
        run(pk, contexts[pk.name]) for pk in BOTH)
    want_sorted = -np.sort(-want, axis=1)[:, :k]
    np.testing.assert_allclose(got_s, want_sorted, rtol=2e-4, atol=1e-4,
                               err_msg=tag)
    rows = np.arange(want.shape[0])[:, None]
    np.testing.assert_allclose(want[rows, got_l], got_s, rtol=2e-4,
                               atol=1e-4, err_msg=tag)
    np.testing.assert_allclose(got_s, ref_s, rtol=2e-4, atol=1e-4,
                               err_msg=tag)


@pytest.mark.parametrize("case", range(_N or 6))
def test_csrmm_fp64_fuzz(case, contexts):
    """float64 csrmm lands on the exact host path whatever the placement:
    within 1e-12 of scipy float64 (relative to max|C|) and of bof_tpu."""
    (ref, _, _), (got, want, tag) = (
        csrmm_case(pk, contexts[pk.name], 7000 + case, case, np.float64)
        for pk in BOTH)
    denom = np.maximum(np.abs(want).max(), 1e-300)
    assert float(np.abs(got - want).max()) / denom < 1e-12, tag
    assert float(np.abs(got - ref).max()) / denom < 1e-12, tag


@pytest.mark.parametrize("case", range(_N or 5))
def test_kmeans_fp64_fuzz(case, contexts):
    """The float64 Lloyd step takes bof_tpu's host step: the port's
    centers, inertia and counts are bof_tpu's bit for bit, and the
    centers the float64 mean within rtol 1e-12."""
    def run(pk, ctx):
        rng = np.random.default_rng(8000 + case)
        n = int(rng.integers(50, 2000))
        d = int(rng.integers(2, 24))
        kk = int(rng.integers(2, 9))
        blk = int(rng.integers(16, max(17, n)))
        pts = rng.standard_normal((n, d)) * np.exp(rng.uniform(-5, 5))
        P = pk.bt.mem_array((n, d), np.float64, data=pts, ctx=ctx)
        c0 = pts[rng.choice(n, kk, replace=False)]
        got = pk.mod("ops.kmeans").lloyds_iter(P, c0, blk_rows=blk, ctx=ctx)
        return got, pts, c0, f"case {case} n{n} d{d} k{kk}"
    (ref, _, _, _), ((got_c, got_i, counts), pts, c0, tag) = (
        run(pk, contexts[pk.name]) for pk in BOTH)
    labels = ((c0 * c0).sum(1)[None, :] - 2.0 * (pts @ c0.T)).argmin(1)
    want_c = np.stack([pts[labels == c].mean(0) if (labels == c).any()
                       else c0[c] for c in range(len(c0))])
    np.testing.assert_allclose(got_c, want_c, rtol=1e-12, atol=0,
                               err_msg=tag)
    assert counts.sum() == len(pts)
    np.testing.assert_array_equal(got_c, ref[0], err_msg=tag)
    assert got_i == ref[1], tag
    np.testing.assert_array_equal(counts, ref[2], err_msg=tag)


@pytest.mark.parametrize("case", range(_N or 12))
def test_hostpar_fuzz(case, monkeypatch):
    """Random shard counts, sizes, dtypes and duplicate densities through
    the parallel host sort (merge-path run merges) and the engine's
    counting argsort: numpy's order, and the port's bits bof_tpu's."""
    rng = np.random.default_rng(7000 + case)
    monkeypatch.setenv("BOF_HOST_THREADS", str(int(rng.integers(2, 11))))
    for pk in BOTH:
        engine(pk)
    n = int(rng.integers(1, 200_000))
    dt = rng.choice([np.float32, np.float64, np.int32, np.int64,
                     np.uint16, np.int8])
    if np.dtype(dt).kind == "f":
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20)
        if rng.random() < 0.5 and n > 4:
            x[rng.integers(0, n, n // 4)] = rng.choice(
                [np.nan, np.inf, -np.inf, 0.0])
        x = x.astype(dt)
    else:
        x = rng.integers(0, int(rng.integers(2, 1 << 14)), n).astype(dt)
    want = np.sort(x.copy())
    k = int(rng.integers(1, 5000))
    keys = rng.integers(0, k, int(rng.integers(0, 100_000))).astype(np.int32)
    outs = []
    for pk in BOTH:
        y = x.copy()
        pk.mod("utils.hostpar").parallel_sort(y)
        order = pk.mod("io.native").counting_argsort_i32(keys, k)
        assert order is not None, pk
        outs.append((y, order))
    (ref_y, ref_order), (y, order) = outs
    if np.dtype(dt).kind == "f":
        np.testing.assert_array_equal(np.isnan(y), np.isnan(want))
        np.testing.assert_array_equal(y[~np.isnan(y)], want[~np.isnan(want)])
    else:
        np.testing.assert_array_equal(y, want)
    np.testing.assert_array_equal(y.view(np.uint8), ref_y.view(np.uint8))
    np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(order, ref_order)
