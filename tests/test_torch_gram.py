"""The eigensolver's operator `apply_gram` (U = A^T (A V)) on the CPU (K2's
plain version), at widths where a band touches a small share of a wide
vocabulary: against the benchmark's float64 plain reference
(`oocbench/reference/gram.py`, plain PyTorch, no module of the port), its
card-side float64 sum against a host fold of the same partials, its
transposed bands over the touched words alone, its transfer modes, the
sharded operator on 2 gloo ranks against one, and block Lanczos's top
singular values against float64 `torch.linalg.svdvals`.

A is drawn by the benchmark's own generator of tf-idf-like documents
(`oocbench/entries/xml_rank.py:docs_csr`: log-normal lengths, Zipf(1)
words), values made non-negative as the eig cell's are.  bof_tpu's
operator and solvers are held to the port's by tests/test_torch_apps.py.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import bof_tpu_torch
import torch_dist_jobs as jobs
from bof_tpu_torch.apps import eigensolver as eig
from bof_tpu_torch.sparse import spmm_device as sdev
from bof_tpu_torch.sparse.csr import fill_row_blocks
from bof_tpu_torch.utils import METRICS
from oocbench.entries.xml_rank import docs_csr
from oocbench.reference import gram
from torch_dist_pool import Pools

SEED = 2**31 + 23


def _zipf(docs, vocab, mean, seed=SEED, longest=2000):
    """scipy CSR (docs x vocab) of Zipf-skewed documents, values |N(0,1)|."""
    cfg = {"docs": docs, "vocab": vocab, "nnz_per_doc_mean": mean,
           "nnz_per_doc_sigma": 1.0, "nnz_per_doc_max": longest,
           "zipf_exponent": 1.0}
    ia, ja, va = docs_csr(cfg, seed, "cpu")
    return sps.csr_matrix((va.abs_().numpy(), ja.numpy(), ia.numpy()),
                          shape=(docs, vocab))


def _ctx(tmp_path, **kw):
    cfg = dict(device="cpu", scratch_dir=str(tmp_path / "scratch"),
               sparse_compute="device", max_nnzs=1 << 16,
               hbm_budget=1 << 24)
    cfg.update(kw)
    return bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(**cfg))


def _reference(a_sp, v, words):
    """float64 U[words] by the plain reference."""
    return gram.gram_rows(torch.from_numpy(a_sp.indptr.astype(np.int64)),
                          torch.from_numpy(a_sp.indices.astype(np.int64)),
                          torch.from_numpy(a_sp.data),
                          torch.from_numpy(v), words).numpy()


@pytest.fixture(scope="module")
def wide():
    """4,096 documents of 40 words on average over 65,536 words, and a
    seeded (65,536 x 16) fp32 panel."""
    a_sp = _zipf(4096, 65536, 40)
    v = np.random.default_rng(3).standard_normal((65536, 16)).astype(
        np.float32)
    return a_sp, v


def _record(monkeypatch):
    """Every column band the operator forms and the fp32 partial it adds
    (host copies), in order."""
    seen = []
    stream = eig._one_pass_stream

    def spy(a, v, ctx, device, fwd, trans, finalize=None):
        def t_product(w, cband):
            rows, u = trans(w, cband)
            seen.append((cband, u.numpy().copy()))
            return rows, u
        return stream(a, v, ctx, device, fwd, t_product, finalize)
    monkeypatch.setattr(eig, "_one_pass_stream", spy)
    return seen


def test_apply_gram_matches_the_plain_reference(wide, tmp_path):
    """Every row of U against float64.  Tolerance 1e-5 of max|U|: W and
    each band's partial are fp32 sums of at most a few thousand terms
    (each ~2^-24 relative), the sum across bands is float64."""
    a_sp, v = wide
    ctx = _ctx(tmp_path)
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        got = bof_tpu_torch.apply_gram(a, v, ctx=ctx)
    finally:
        ctx.destroy()
    want = _reference(a_sp, v, np.arange(a_sp.shape[1]))
    assert got.dtype == np.float64 and got.shape == v.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the words no document holds stay exact zeros
    assert not got[np.diff(a_sp.tocsc().indptr) == 0].any()


def test_u_summed_on_the_card_is_the_host_fold_bit_for_bit(
        wide, tmp_path, monkeypatch):
    """U's float64 additions on the card (index_add_ into U) give the
    bits of the host fold `U[rows] += u` over the same partials in the
    same band order; several row blocks, bands and column bands, the
    bands formed on three threads."""
    a_sp, v = wide
    seen = _record(monkeypatch)
    monkeypatch.setenv("BOF_HOST_THREADS", "3")  # bands formed on 3
    ctx = _ctx(tmp_path, max_nnzs=1 << 14, hbm_budget=1 << 23)
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        got = bof_tpu_torch.apply_gram(a, v, ctx=ctx)
    finally:
        ctx.destroy()
    assert len(fill_row_blocks(a_sp.indptr, 1 << 14)) > 1
    host = np.zeros(v.shape, np.float64)
    for cband, u in seen:
        host[cband.rows] += u
    assert len(seen) > 4
    assert got.tobytes() == host.tobytes()


def test_column_bands_hold_only_the_words_a_band_touches(tmp_path,
                                                         monkeypatch):
    """On a vocabulary far wider than its rows touch, each forward band's
    column bands hold exactly the distinct words of the band's rows (no
    zero-count word is planned, launched or added): `eig.t_rows` is the
    sum of the bands' distinct words, not bands x vocab."""
    vocab, b = 1_000_000, 4
    a_sp = _zipf(512, vocab, 30)
    v = np.random.default_rng(5).standard_normal((vocab, b)).astype(
        np.float32)
    seen = _record(monkeypatch)
    cfg = dict(max_nnzs=4096, hbm_budget=48 * vocab * b)
    ctx = _ctx(tmp_path, **cfg)
    before = {n: METRICS.get(n) for n in ("eig.fwd_bands", "eig.t_bands",
                                          "eig.t_rows")}
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        bof_tpu_torch.apply_gram(a, v, ctx=ctx)
    finally:
        ctx.destroy()
    got = {n: METRICS.get(n) - x for n, x in before.items()}
    cap = eig._gram_entry_cap(cfg["hbm_budget"], vocab, b)
    fwd = touched = 0
    for r, e in fill_row_blocks(a_sp.indptr, cfg["max_nnzs"]):
        blk = a_sp[r:e]
        order, ranges = sdev.band_plan(np.diff(blk.indptr), cap)
        for s0, s1 in ranges:
            fwd += 1
            touched += len(np.unique(blk[order[s0:s1]].indices))
    assert fwd > 1
    assert got["eig.fwd_bands"] == fwd
    assert got["eig.t_rows"] == touched < fwd * vocab // 100
    assert got["eig.t_bands"] == len(seen)
    assert all((cband.counts > 0).all() for cband, _ in seen)


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_bands_honor_the_transfer_dtype(wide, tmp_path, mode):
    """FlashConfig.transfer_dtype reaches both halves' ELL values, as
    csrmm's bands (bof_tpu's operator ships fp32 whatever it says): bf16
    values on values bf16 holds exactly give fp32's U bit for bit with
    fewer bytes up; int8 values (a scale an ELL row) stay within 2e-2 of
    fp32's U and differ from it."""
    a_sp, v = wide
    a_sp = a_sp.copy()
    if mode == "bfloat16":
        a_sp.data = torch.from_numpy(a_sp.data).bfloat16().float().numpy()
    out = {}
    for td in ("float32", mode):
        ctx = _ctx(tmp_path / td, transfer_dtype=td)
        before = METRICS.get("eig.h2d_bytes")
        try:
            a = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
            out[td] = (bof_tpu_torch.apply_gram(a, v, ctx=ctx),
                       METRICS.get("eig.h2d_bytes") - before)
        finally:
            ctx.destroy()
    (fp32, up32), (low, up_low) = out["float32"], out[mode]
    assert up_low < up32
    if mode == "bfloat16":
        assert low.tobytes() == fp32.tobytes()
    else:
        assert not np.array_equal(low, fp32)
        assert np.abs(low - fp32).max() <= 2e-2 * np.abs(fp32).max()


def test_solvers_reach_u_through_apply_gram(tmp_path, monkeypatch):
    """block_lanczos_svd and block_power_svd take every operator
    application from apply_gram, one-pass and two-pass alike."""
    calls = []
    real = eig.apply_gram

    def counted(*args, **kw):
        calls.append(kw.get("one_pass"))
        return real(*args, **kw)
    monkeypatch.setattr(eig, "apply_gram", counted)
    a_sp = _zipf(200, 600, 12)
    ctx = _ctx(tmp_path)
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        for one_pass in (None, False):
            for solve, kw in ((eig.block_lanczos_svd, {"n_restarts": 2}),
                              (eig.block_power_svd, {"n_iters": 2})):
                before = METRICS.get("eig.op_applies")
                calls.clear()
                solve(a, 3, one_pass=one_pass, ctx=ctx, **kw)
                applies = METRICS.get("eig.op_applies") - before
                assert len(calls) == applies > 0
                assert set(calls) == {one_pass is None}
    finally:
        ctx.destroy()


def test_lanczos_top_sigmas_match_float64_svdvals(tmp_path):
    """block_lanczos_svd's top 8 singular values on the one-pass device
    operator against torch.linalg.svdvals of the densified float64 A, rtol
    1e-5: the operator is fp32 at 1e-7 of U, and the thick-restart
    iteration runs to 1e-9."""
    a_sp = _zipf(600, 4000, 30)
    ctx = _ctx(tmp_path)
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        sigma, v = bof_tpu_torch.block_lanczos_svd(a, 8, tol=1e-9,
                                                   n_restarts=12, ctx=ctx)
    finally:
        ctx.destroy()
    want = gram.svdvals(torch.from_numpy(a_sp.indptr.astype(np.int64)),
                        torch.from_numpy(a_sp.indices.astype(np.int64)),
                        torch.from_numpy(a_sp.data),
                        a_sp.shape[1]).numpy()[:8]
    np.testing.assert_allclose(sigma, want, rtol=1e-5)
    assert v.shape == (a_sp.shape[1], 8)


@pytest.fixture(scope="module")
def pools():
    p = Pools()
    yield p
    p.close()


def test_sharded_one_pass_on_two_ranks_matches_one(pools, wide, tmp_path):
    """The sharded one-pass operator on 2 gloo ranks (each rank's words
    added into its own U on its device, one float64 all-reduce) against
    the one-card operator: every fp32 partial is the same, so only the
    float64 order of additions across ranks differs (1e-12 of max|U|)."""
    a_sp, v = wide
    cfg = {"max_nnzs": 1 << 15, "hbm_budget": 1 << 24}
    ctx = _ctx(tmp_path, **cfg)
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(
            a_sp, backing="file", path_prefix=os.path.join(tmp_path, "A"),
            ctx=ctx)
        one = eig._apply_ata_one_pass_device(a, v, ctx)
    finally:
        ctx.destroy()
    out = pools.get(2).run(jobs.one_pass, str(tmp_path), "A", a_sp.shape, v,
                           cfg)
    for u in out:
        assert u.dtype == np.float64
        np.testing.assert_allclose(u, one, rtol=1e-12,
                                   atol=1e-12 * np.abs(one).max())
    np.testing.assert_array_equal(out[0], out[1])
