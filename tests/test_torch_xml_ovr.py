"""One-vs-rest XML inference through the port's fused `xml_rank` path, on
the CPU (the kernels' plain versions), against the benchmark's plain
float64 reference (`oocbench/reference/xml_ovr.py`, plain PyTorch, no
module of the port); both paths on these documents against bof_tpu:
`tests/test_torch_apps.py::test_xml_rank_matches_dense_topk`.

A is drawn by the benchmark's own generator of Amazon-670K-like documents
(`oocbench/entries/xml_rank.py:docs_csr`: log-normal lengths, Zipf-skewed
columns) and W is a (labels x vocab) fp32 file whose rows are 4 * vocab
bytes, vocab odd, so no row after the first starts on a 4 KiB boundary
(Amazon-670K's rows are 543,636 B).  The fused path streams W's label
panels through the Program Cache (the native pin cache): within a budget
below W's bytes a second call reads W again, and within one above them it
hits every panel.  Every stage of the fused path runs in a span that
books its counter.
"""
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import bof_tpu_torch
from bof_tpu_torch.utils import METRICS
from oocbench.entries.xml_rank import docs_csr
from oocbench.reference import xml_ovr

F32 = np.float32
DOCS, VOCAB, LABELS, K, PANEL = 300, 1001, 203, 5, 64
PANELS = -(-LABELS // PANEL)
W_BYTES = LABELS * VOCAB * 4
DOCS_CFG = {"docs": DOCS, "vocab": VOCAB, "nnz_per_doc_mean": 24,
            "nnz_per_doc_sigma": 1.0, "nnz_per_doc_max": 2000,
            "zipf_exponent": 1.0}


def _ctx(tmp_path, **kw):
    cfg = dict(device="cpu", scratch_dir=str(tmp_path / "scratch"),
               io_backend="native", program_budget=64 << 20,
               max_nnzs=4096)
    cfg.update(kw)
    return bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(**cfg))


@pytest.fixture(scope="module")
def case():
    """(A as scipy CSR, W (labels x vocab) fp32)."""
    ia, ja, va = docs_csr(DOCS_CFG, 2**31 + 19, "cpu")
    a = sps.csr_matrix((va.numpy(), ja.numpy(), ia.numpy()),
                       shape=(DOCS, VOCAB))
    w = np.random.default_rng(7).standard_normal((LABELS, VOCAB)).astype(F32)
    return a, w


def _reference(a, w):
    """float64 (docs, labels) scores A W^T by the plain reference."""
    return xml_ovr.scores(torch.from_numpy(a.indptr.astype(np.int64)),
                          torch.from_numpy(a.indices.astype(np.int64)),
                          torch.from_numpy(a.data), torch.from_numpy(w),
                          range(a.shape[0])).numpy()


def _files(tmp_path, a, w, ctx):
    prefix = str(tmp_path / "A")
    a.indptr.astype(np.int64).tofile(prefix + ".off")
    a.indices.astype(np.int64).tofile(prefix + ".col")
    a.data.astype(F32).tofile(prefix + ".csr")
    w.tofile(str(tmp_path / "W"))
    return (bof_tpu_torch.CsrFlashMatrix.map_files(prefix, a.shape, ctx=ctx),
            bof_tpu_torch.map_array(str(tmp_path / "W"), w.shape, F32,
                                    ctx=ctx))


def _outputs(ctx):
    return (bof_tpu_torch.mem_array((DOCS, K), F32, ctx=ctx),
            bof_tpu_torch.mem_array((DOCS, K), np.int32, ctx=ctx))


def _check(a, w, scores, labels):
    """The returned scores are the reference's top-k scores, and the
    reference's scores at the returned labels: a wrong label fails, a
    near-tie that rounding flips does not."""
    ref = _reference(a, w)
    want_s = xml_ovr.top_k(torch.from_numpy(ref), K).numpy()
    assert labels.min() >= 0 and labels.max() < LABELS
    at = np.take_along_axis(ref, labels, axis=1)
    scale = np.abs(want_s).max()
    np.testing.assert_allclose(scores, want_s, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(scores, at, rtol=0, atol=2e-6 * scale)
    assert (np.diff(scores, axis=1) <= 0).all()
    for row in labels:
        assert len(set(row)) == K


def test_the_inputs_are_skewed_and_off_alignment(case):
    a, w = case
    assert VOCAB % 4 and (VOCAB * 4) % 4096 and LABELS % PANEL
    lengths = np.diff(a.indptr)
    assert lengths.min() >= 1 and lengths.max() > 4 * lengths.mean()
    for r in range(DOCS):
        row = a.indices[a.indptr[r]:a.indptr[r + 1]]
        assert (np.diff(row) > 0).all()  # sorted, no column twice
    hits = np.bincount(a.indices, minlength=VOCAB)
    assert np.sort(hits)[-10:].sum() > 0.15 * a.nnz  # a Zipf head


def _w_reads(ctx, a, w, A, W):
    """The bytes the pin cache read from disk in one fused call, and its
    misses."""
    before = ctx.pin_cache_stats()
    s, l = _outputs(ctx)
    bof_tpu_torch.xml_rank(A, W, K, scores_out=s, labels_out=l,
                           label_blk=PANEL, fused=True, ctx=ctx)
    _check(a, w, s.read_all(), l.read_all())
    after = ctx.pin_cache_stats()
    assert after["used"] <= ctx.config.program_budget
    return (after["read_bytes"] - before["read_bytes"],
            after["misses"] - before["misses"])


@pytest.mark.parametrize("budget", [W_BYTES // 2, 4 * W_BYTES])
def test_the_budget_binds_w_panels(tmp_path, case, budget):
    """The first call reads all of W through the cache; below W's bytes
    the second call reads panels of W from disk again, above them every
    pin of the second call hits."""
    a, w = case
    ctx = _ctx(tmp_path, program_budget=budget)
    try:
        A, W = _files(tmp_path, a, w, ctx)
        first, _ = _w_reads(ctx, a, w, A, W)
        again, misses = _w_reads(ctx, a, w, A, W)
    finally:
        ctx.destroy()
    assert first >= W_BYTES
    if budget < W_BYTES:
        assert again >= PANEL * VOCAB * 4 and misses >= 1
    else:
        assert again == 0 and misses == 0


def test_w_is_not_read_outside_the_cache(tmp_path, case, monkeypatch):
    """The fused path takes W's panels from the pin cache only: no
    synchronous read of W's store."""
    a, w = case
    ctx = _ctx(tmp_path)
    try:
        A, W = _files(tmp_path, a, w, ctx)

        def refused(*args, **kw):
            raise AssertionError("W read outside the Program Cache")
        monkeypatch.setattr(W.store, "read_sync", refused)
        monkeypatch.setattr(W, "read_block_storage", refused)
        s, l = _outputs(ctx)
        bof_tpu_torch.xml_rank(A, W, K, scores_out=s, labels_out=l,
                               label_blk=PANEL, fused=True, ctx=ctx)
        _check(a, w, s.read_all(), l.read_all())
    finally:
        ctx.destroy()


STAGES = ("w_wait", "w_h2d", "disk_wait", "prep", "h2d", "dispatch", "d2h",
          "merge")


def test_each_span_books_its_counter(tmp_path, case):
    """The entry span and every stage's book `<name>_s`; only rows x k
    scores and labels come down, once a label panel."""
    a, w = case
    ctx = _ctx(tmp_path)
    try:
        A, W = _files(tmp_path, a, w, ctx)
        s, l = _outputs(ctx)
        m0 = METRICS.snapshot()
        bof_tpu_torch.xml_rank(A, W, K, scores_out=s, labels_out=l,
                               label_blk=PANEL, fused=True, ctx=ctx)
        booked = {k: v - m0.get(k, 0.0)
                  for k, v in METRICS.snapshot().items()}
    finally:
        ctx.destroy()
    assert booked["xml_rank_s"] > 0
    for stage in STAGES:
        assert booked.get(f"xml_rank.{stage}_s", 0) > 0, stage
    assert "xml_rank.w_read_s" not in booked
    assert booked["xml_rank.d2h_bytes"] == DOCS * K * 8 * PANELS
    assert booked["xml_rank.h2d_bytes"] >= W_BYTES


@pytest.mark.parametrize("budget,panel", [
    (64 << 20, PANEL),               # the panel asked for
    (2 * PANEL * VOCAB * 4, PANEL),  # half the budget holds it exactly
    (2 * 40 * VOCAB * 4, 40),        # the panel cut to half the budget
    (6 * VOCAB * 4, K),              # never below k labels
])
def test_w_panels_stay_inside_half_the_budget(tmp_path, case, budget, panel):
    """The fused path's panel is `label_blk` cut to the labels half the
    Program Cache's budget holds, never below k: one (docs x k) download a
    panel, and the answer is the reference's."""
    a, w = case
    # A's pins (12 B a nonzero) fit the smallest budget
    ctx = _ctx(tmp_path, program_budget=budget, max_nnzs=1024)
    try:
        A, W = _files(tmp_path, a, w, ctx)
        s, l = _outputs(ctx)
        before = METRICS.get("xml_rank.d2h_bytes")
        bof_tpu_torch.xml_rank(A, W, K, scores_out=s, labels_out=l,
                               label_blk=PANEL, fused=True, ctx=ctx)
        moved = METRICS.get("xml_rank.d2h_bytes") - before
        _check(a, w, s.read_all(), l.read_all())
    finally:
        ctx.destroy()
    assert moved == DOCS * K * 8 * -(-LABELS // panel)


def _banding(monkeypatch):
    """Records each `ell_bands` call of the fused path: (the host bytes of
    the block's bands, their number)."""
    from bof_tpu_torch.sparse import spmm_device as sdev
    made, real = [], sdev.ell_bands

    def counting(*args, **kw):
        bands = real(*args, **kw)
        made.append((sum(b.rows.nbytes + b.counts.nbytes + b.ja.nbytes
                         + b.va.nbytes for b in bands), len(bands)))
        return bands
    monkeypatch.setattr(sdev, "ell_bands", counting)
    return made


def _banded_call(tmp_path, a, w, ctx, label_blk):
    """One fused call: (scores, labels, the bands it built, the bands it
    served from kept ones)."""
    A, W = _files(tmp_path, a, w, ctx)
    s, l = _outputs(ctx)
    m0 = METRICS.snapshot()
    bof_tpu_torch.xml_rank(A, W, K, scores_out=s, labels_out=l,
                           label_blk=label_blk, fused=True, ctx=ctx)
    m1 = METRICS.snapshot()
    built, reused = (m1.get(n, 0) - m0.get(n, 0)
                     for n in ("xml_rank.bands_built",
                               "xml_rank.bands_reused"))
    return s.read_all(), l.read_all(), built, reused


# an entry cap of 2^14 (the least), so a block bands into several bands
SMALL_HBM = 1 << 20


def test_each_row_block_is_banded_once_a_call(tmp_path, case, monkeypatch):
    """Within the default budget every row block's bands are kept: one
    `ell_bands` a block, not one a block and label panel, and each kept
    band serves the panels after the first."""
    from bof_tpu_torch.sparse.csr import fill_row_blocks
    a, w = case
    made = _banding(monkeypatch)
    ctx = _ctx(tmp_path, hbm_budget=SMALL_HBM)
    try:
        s, l, built, reused = _banded_call(tmp_path, a, w, ctx, PANEL)
    finally:
        ctx.destroy()
    _check(a, w, s, l)
    blocks = fill_row_blocks(a.indptr.astype(np.int64), 4096)
    one_pass = sum(n for _, n in made)
    assert PANELS == 4 and len(blocks) > 1 and one_pass > len(blocks)
    assert len(made) == len(blocks)
    assert built == one_pass and reused == one_pass * (PANELS - 1)


@pytest.fixture(scope="module")
def kept_everywhere(case, tmp_path_factory):
    """A fused call in panels of k labels whose budget keeps every block's
    bands: (scores, labels, each block's (band bytes, bands))."""
    a, w = case
    tmp = tmp_path_factory.mktemp("kept")
    with pytest.MonkeyPatch.context() as mp:
        made = _banding(mp)
        ctx = _ctx(tmp, hbm_budget=SMALL_HBM, max_nnzs=1024)
        try:
            s, l, _, _ = _banded_call(tmp, a, w, ctx, K)
        finally:
            ctx.destroy()
    return s, l, made


@pytest.mark.parametrize("keeps", ["every", "first", "no"])
def test_kept_bands_give_the_bits_of_fresh_ones(tmp_path, case,
                                                kept_everywhere, keeps):
    """Panels of k labels (which no budget cuts) within a budget whose half
    holds every block's bands, only the first block's, or none: the same
    scores and labels, bit for bit, and a band is reused only where its
    block's bands were kept."""
    a, w = case
    s0, l0, made = kept_everywhere
    panels = -(-LABELS // K)
    sizes = [nb for nb, _ in made]
    budget = {"every": 64 << 20, "first": 2 * sizes[0] + 1,
              "no": 2 * min(sizes) - 1}[keeps]
    ctx = _ctx(tmp_path, hbm_budget=SMALL_HBM, max_nnzs=1024,
               program_budget=budget)
    try:
        s, l, built, reused = _banded_call(tmp_path, a, w, ctx, K)
    finally:
        ctx.destroy()
    np.testing.assert_array_equal(s, s0)
    np.testing.assert_array_equal(l, l0)
    one_pass = sum(n for _, n in made)
    kept = {"every": one_pass, "first": made[0][1], "no": 0}[keeps]
    assert len(made) > 2
    assert reused == kept * (panels - 1)
    assert built + reused == one_pass * panels
