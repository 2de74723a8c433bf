"""Out-of-core extreme multi-label (XML) ranking inference.

The port of `bof_tpu/apps/xml_rank.py` (the NSDI'19 paper's Table 6
workload: linear label scoring over bag-of-words features, top-k labels a
document):

    S = A W^T          A (docs x vocab) sparse CSR on flash,
                       W (labels x vocab) dense label weights on flash,
    topk(S, k)         per-document label ranking.

Two execution paths, as in bof_tpu:

- **Fused device path (default on the card).** Per label block, W's
  label rows stream through the Program Cache (the pin cache, a lookahead
  inside its budget), go up once from the pinned rows and are transposed
  on the card into the (vocab x lb_max) fp32 panel; sparse row blocks
  stream through the pin cache and are banded once a call (the host
  bands serve every label block, within half the cache's budget); each
  ELL band is one launch of K2 (the block product, into a (rows x lb_max)
  buffer on the card) and one of B8 (`ops/topk_cuda.py:row_topk`: the
  label mask and the per-row top-k, in lax.top_k's order), so only
  (rows x k) scores and ids cross the link.
- **csrmm-composition path** (host sparse compute, or `fused=False`): per
  label block, S_b = A @ W_b^T lands on flash scratch via one csrmm pass,
  then the running (docs x k) top-k panels merge per doc block on the host.

With `mesh=` (a `DeviceMesh`, parallel.make_mesh) the scoring pass runs
row-sharded over the mesh's ranks: on the fused path each rank runs K2
and B8 on its run of each band's rows and two all-gathers bring the
band's (rows x k) scores and labels to every rank (nothing wider
crosses); on the
composition path `csrmm_sharded` writes the score panel.  Rank 0 merges
the top-k panels, which every rank sees (shared scratch by default, or
the caller's files), and a barrier ends the call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..context import get_context
from ..core.flash_array import FlashArray, flash_empty, flash_free
from ..ops import device as dev
from ..ops.topk_cuda import row_topk
from ..sparse import CsrFlashMatrix, csrmm
from ..utils import LOG, METRICS, Timer


def _topk_step(b_panel, ja_ell, va_ell, counts, label_mask, k: int):
    """bof_tpu's fused step on one ELL band: (top-k scores, top-k label
    offsets) of spmm_ell(b_panel, ja, va) + label_mask, K2 then B8.  The
    band's rows are those of ja/va (counts gives each one's real slots);
    label_mask is 0 on real labels and -inf on the padded tail
    (zero-padded W columns would otherwise score 0 and beat real negative
    scores)."""
    from ..sparse.spmm_device import spmm_ell_block
    s = spmm_ell_block(b_panel, ja_ell, va_ell, counts=counts)
    return row_topk(s, label_mask, k)


def _topk_band_sharded(mesh, b_panel, ja_loc, va_loc, counts_loc,
                       label_mask, k: int, run: int):
    """bof_tpu's `_topk_step_sharded` on one band: K2, then B8, on this
    rank's run of the band's rows (`row_run`), then all-gathers of the
    (run x k) scores and label offsets, so every rank holds the band's
    results in row order (rows past the band are padding)."""
    from ..parallel.mesh import all_gather, n_ranks
    device = b_panel.device
    vals = torch.full((run, k), -float("inf"), dtype=torch.float32,
                      device=device)
    idx = torch.zeros((run, k), dtype=torch.int32, device=device)
    if ja_loc.shape[0]:
        v, i = _topk_step(b_panel, ja_loc, va_loc, counts_loc, label_mask,
                          k)
        vals[:v.shape[0]] = v
        idx[:i.shape[0]] = i
    n_dev = n_ranks(mesh)
    out_v = vals.new_empty((n_dev * run, k))
    out_i = idx.new_empty((n_dev * run, k))
    all_gather(out_v, vals)
    all_gather(out_i, idx)
    return out_v, out_i


def _label_axis(w: FlashArray) -> Tuple[int, int]:
    """(n_labels, vocab) for a label-weight matrix stored with one label's
    weight vector per storage line: (labels x vocab) row-major or
    (vocab x labels) column-major."""
    if len(w.shape) != 2:
        raise ValueError("W must be 2-D")
    if w.order == "R":
        return w.shape[0], w.shape[1]
    return w.shape[1], w.shape[0]


def _wt_view(w: FlashArray, b0: int, lb: int, vocab: int) -> FlashArray:
    """Zero-copy (vocab x lb) column-major view of label rows [b0, b0+lb)
    — the W_b^T operand for csrmm, no bytes moved or transposed."""
    return FlashArray(w.store, (vocab, lb), w.dtype, "C",
                      offset=w.offset + b0 * w.ld * w.itemsize,
                      ld=w.ld, ctx=w.ctx)


def _merge_topk(scores: FlashArray, labels: FlashArray, r0: int,
                s_new: np.ndarray, l_new: np.ndarray, k: int, first: bool):
    """Merge (bn, w) candidate scores/labels into the running flash-
    resident (docs, k) top-k panels at doc rows [r0, r0+bn)."""
    bn = s_new.shape[0]
    if first:
        cand_s, cand_l = s_new, l_new
    else:
        cand_s = np.concatenate([scores.read_block(r0, bn, 0, k), s_new],
                                axis=1)
        cand_l = np.concatenate([labels.read_block(r0, bn, 0, k), l_new],
                                axis=1)
    if cand_s.shape[1] > k:
        part = np.argpartition(-cand_s, k - 1, axis=1)[:, :k]
    else:  # first candidates narrower than k: pad to full width
        pad = k - cand_s.shape[1]
        cand_s = np.concatenate(
            [cand_s, np.full((bn, pad), -np.inf, np.float32)], axis=1)
        cand_l = np.concatenate(
            [cand_l, np.full((bn, pad), -1, np.int32)], axis=1)
        part = np.broadcast_to(np.arange(k), (bn, k))
    rows = np.arange(bn)[:, None]
    top_s = cand_s[rows, part]
    top_l = cand_l[rows, part]
    order = np.argsort(-top_s, axis=1, kind="stable")
    scores.write_block(r0, top_s[rows, order].astype(np.float32), 0)
    labels.write_block(r0, top_l[rows, order].astype(np.int32), 0)


def _upload_panel(wt_st: np.ndarray, lb_max: int, device,
                  lock) -> torch.Tensor:
    """The (vocab x lb_max) fp32 W operand of K2 on the card from W's
    (lb, vocab) label rows (a pin-cache buffer, whole): one upload of the
    rows as they are, one transpose on the card, zero columns past lb.
    Always float32, so every label block runs the same fp32 product
    (bof_tpu's rule).  Where the rows go up as they stand (fp32 W),
    `lock()` first page-locks their buffer."""
    lb, vocab = wt_st.shape
    src = wt_st.astype(np.float32, copy=False)
    if dev.is_whole(src, wt_st):
        lock()
    up = dev.to_device(src, device)
    if lb == lb_max:
        return up.T.contiguous()
    panel = torch.zeros((vocab, lb_max), dtype=torch.float32, device=device)
    panel[:, :lb] = up.T
    return panel


def _band_bytes(band) -> int:
    """The host bytes of a band: its rows, counts, ja and values."""
    return (band.rows.nbytes + band.counts.nbytes + band.ja.nbytes
            + band.va.nbytes)


def _xml_rank_fused(a: CsrFlashMatrix, w: FlashArray, k: int,
                    scores: FlashArray, labels: FlashArray,
                    lb_max: int, ctx, mesh=None) -> None:
    """Fused device path: per ELL band one K2 and one B8 launch, only
    (rows x k) crossing the link; no score panel beyond one band's
    (rows x lb_max) buffer on the card.  W's label panels stream through
    the Program Cache (`ctx.pin_cache()`, as many panels ahead as half
    its budget holds) and go up from the pinned rows.  With `mesh`, each
    rank takes its run of the band's rows and all-gathers of the
    (rows x k) results give every rank the band (`_topk_band_sharded`);
    rank 0 merges.  A row block's bands do not depend on the label panel:
    each block is banded on the first panel and its bands are kept on the
    host for the others while all kept bands fit half the Program Cache's
    budget (the half A's blocks have, beside W's); a block past that is
    streamed and banded anew each panel.  METRICS counts
    `xml_rank.bands_built` and `xml_rank.bands_reused` (a band launched
    from a kept band).  Every stage runs in a span `xml_rank.<stage>`
    (METRICS.span), which books its seconds as `xml_rank.<stage>_s`."""
    from ..core.pipeline import PrefetchSeq
    from ..sparse import spmm_device as sdev
    from ..sparse.csr import fill_row_blocks, stream_row_blocks

    cfg = ctx.config
    if mesh is None:
        device = dev.resolve_device(cfg.device)
        merges = True
    else:
        from ..parallel import mesh as pmesh
        device = pmesh.mesh_device(mesh)
        merges = pmesh.flat_rank(mesh) == 0
    docs, vocab = a.shape
    n_labels, _ = _label_axis(w)
    # W's pins in flight hold at most half the budget (the other half is
    # A's blocks and what stays cached): the cache evicts only when a pin
    # misses, so a lookahead past the budget would hold its pins over it
    ahead = max(1, min(cfg.pipeline_depth, cfg.program_budget // 2
                       // max(lb_max * vocab * w.itemsize, 1)))
    ia_np = a.read_ia()
    blocks = fill_row_blocks(ia_np, cfg.max_nnzs)
    entry_cap = max(1 << 14, int(cfg.hbm_budget // 6 // max(lb_max * 4, 1)))
    ell_idt = sdev.ell_idx_dtype(vocab, getattr(cfg, "ell_idx_narrow", True))
    ell_vdt = sdev.ell_val_dtype(a.vals.dtype, cfg)

    panels = [(b0, min(lb_max, n_labels - b0))
              for b0 in range(0, n_labels, lb_max)]
    # each panel's lb label rows, one pin: (lb, vocab) in storage order
    # for either W layout (`_wt_view`)
    w_pins = PrefetchSeq(ctx.pin_cache(), [
        (w.store,) + _wt_view(w, b0, lb, vocab).block_access(0, vocab, 0, lb)
        for b0, lb in panels], depth=ahead)
    kept = {}  # row block -> its bands, for the panels after the first
    kept_bytes = 0
    keep_cap = cfg.program_budget // 2 if len(panels) > 1 else 0

    def row_block_bands():
        """(r, e, bands) of each row block in order: the bands kept for
        it, else the block streamed through the pin cache and banded."""
        nonlocal kept_bytes
        fresh = stream_row_blocks(
            a, ia_np, [blk for i, blk in enumerate(blocks) if i not in kept],
            ctx, wait_span="xml_rank.disk_wait")
        try:
            for i, (r, e) in enumerate(blocks):
                if i in kept:
                    METRICS.add("xml_rank.bands_reused", len(kept[i]))
                    yield r, e, kept[i]
                    continue
                _, _, ja_blk, va_blk = next(fresh)
                with METRICS.span("xml_rank.prep"):
                    # the count-sorted ELL bands
                    bands = sdev.ell_bands(ia_np[r:e + 1] - int(ia_np[r]),
                                           ja_blk, va_blk, entry_cap, cfg,
                                           ell_idt, ell_vdt)
                METRICS.add("xml_rank.bands_built", len(bands))
                # kept bytes only grow, so a block that does not fit on the
                # first panel fits on none
                nbytes = sum(map(_band_bytes, bands))
                if kept_bytes + nbytes <= keep_cap:
                    kept[i] = bands
                    kept_bytes += nbytes
                yield r, e, bands
        finally:
            fresh.close()

    try:
        for p, (b0, lb) in enumerate(panels):
            with METRICS.span("xml_rank.w_wait"):
                wt_st = w_pins.get(p).view(w.dtype).reshape(lb, vocab)
            with METRICS.span("xml_rank.w_h2d"):
                # (vocab, lb_max) row-major on the card: one upload, one
                # transpose
                b_panel = _upload_panel(wt_st, lb_max, device,
                                        lambda: w_pins.lock(p))
                mask = np.zeros(lb_max, np.float32)
                mask[lb:] = -np.inf  # padded labels must never win
                mask_dev = dev.to_device(mask, device)
            del wt_st
            w_pins.done(p)
            METRICS.add("xml_rank.h2d_bytes", lb * vocab * 4 + mask.nbytes)
            first = b0 == 0

            for r, e, bands in row_block_bands():
                # results stage per block so the top-k merge stays a
                # contiguous panel write
                s_stage = np.empty((e - r, k), np.float32)
                l_stage = np.empty((e - r, k), np.int32)
                for band in bands:
                    n_sel = len(band.rows)
                    lo, hi = 0, n_sel
                    if mesh is not None:
                        lo, hi, run = pmesh.row_run(mesh, n_sel)
                    with METRICS.span("xml_rank.h2d") as sp:
                        # B8 writes a band row's top-k, placed on the host
                        up = sdev.upload_band(band, device, lo, hi,
                                              with_rows=False)
                        sp.nbytes = up.nbytes
                    with METRICS.span("xml_rank.dispatch"):
                        if mesh is None:
                            vals, idx = _topk_step(b_panel, up.ja, up.va,
                                                   up.counts, mask_dev, k)
                        else:
                            vals, idx = _topk_band_sharded(
                                mesh, b_panel, up.ja, up.va, up.counts,
                                mask_dev, k, run)
                    del up
                    with METRICS.span("xml_rank.d2h") as sp:
                        # waits for K2 and B8
                        vals_np = dev.from_device(vals)[:n_sel]
                        idx_np = dev.from_device(idx)[:n_sel]
                        sp.nbytes = vals_np.nbytes + idx_np.nbytes
                    s_stage[band.rows] = vals_np
                    l_stage[band.rows] = idx_np + b0
                if merges:
                    with METRICS.span("xml_rank.merge"):
                        _merge_topk(scores, labels, r, s_stage, l_stage, k,
                                    first)
            del b_panel
    finally:
        w_pins.close()


@METRICS.span("xml_rank")
def xml_rank(a: CsrFlashMatrix, w: FlashArray, k: int,
             scores_out: Optional[FlashArray] = None,
             labels_out: Optional[FlashArray] = None,
             label_blk: Optional[int] = None,
             doc_blk: Optional[int] = None,
             fused: Optional[bool] = None,
             mesh=None, ctx=None) -> Tuple[FlashArray, FlashArray]:
    """Top-k labels per document: returns (scores (docs, k) float32
    descending per row, labels (docs, k) int32).  Output panels live on
    flash (caller-provided or scratch).  `label_blk` bounds the streamed
    W panel (on the fused path also half the Program Cache's budget, as
    its label rows are pinned whole); `doc_blk` bounds host merge
    memory.

    `fused` selects the fused K2 + B8 path (default: on, unless the
    link/problem heuristic picks host sparse compute — the same placement
    logic as csrmm — or the W panel would not fit a third of the device
    budget).  With `mesh` (parallel.make_mesh) the scoring pass runs
    row-sharded over the mesh, fused by default; in a world of several
    ranks, rank 0 writes the output panels, which must then be files
    every rank sees (the default scratch panels are)."""
    ctx = ctx or a.ctx or w.ctx or get_context()
    cfg = ctx.config
    docs, vocab = a.shape
    n_labels, w_vocab = _label_axis(w)
    if w_vocab != vocab:
        raise ValueError(f"W vocab {w_vocab} != A vocab {vocab}")
    if not 1 <= k <= n_labels:
        raise ValueError(f"k={k} out of range [1, {n_labels}]")

    lb_max = label_blk or max(k, min(n_labels,
                                     int(cfg.program_budget // 16
                                         // max(vocab * 4, 1)) or 1,
                                     4096))
    lb_max = max(lb_max, 1)
    db = doc_blk or max(1, min(docs, (32 << 20) // max(4 * (lb_max + k), 1)))

    if mesh is None:
        def _empty(shape, dtype):
            return flash_empty(shape, dtype, ctx=ctx)
    else:
        from ..parallel import mesh as pmesh

        def _empty(shape, dtype):
            return pmesh.shared_empty(shape, dtype, mesh, ctx)
    scores = scores_out or _empty((docs, k), np.float32)
    labels = labels_out or _empty((docs, k), np.int32)
    if scores.shape != (docs, k) or labels.shape != (docs, k):
        raise ValueError("output panels must be (docs, k)")

    timer = Timer()
    if fused is None:
        from ..sparse.csrmm import _resolve_sparse_compute
        # the fused step holds the whole (vocab x lb) W panel on the card;
        # at huge vocab fall back to the composition path, whose csrmm
        # K-splits oversized panels
        fused = (vocab * max(lb_max, k) * 4 <= cfg.hbm_budget // 3
                 and (mesh is not None
                      or _resolve_sparse_compute(cfg, docs, vocab, lb_max,
                                                 a.nnz) != "host"))
    if fused:
        # a panel's label rows are pinned whole: at most half the Program
        # Cache's budget, and at least k labels for the top-k
        lb_max = max(k, min(lb_max, cfg.program_budget // 2
                            // max(vocab * w.itemsize, 1)))
        _xml_rank_fused(a, w, k, scores, labels, lb_max, ctx, mesh=mesh)
        scores.store.flush()
        labels.store.flush()
        if mesh is not None and pmesh.n_ranks(mesh) > 1:
            pmesh.barrier()  # rank 0's panels are on disk
        LOG.debug("xml_rank[fused]: %d docs x %d labels top-%d in %.0f ms",
                  docs, n_labels, k, timer.elapsed_ms())
        return scores, labels

    s_blk = _empty((docs, lb_max), np.float32)
    merges = mesh is None or pmesh.flat_rank(mesh) == 0
    # the next block's csrmm overwrites s_blk: no rank may start it before
    # rank 0 has merged this block
    waits = mesh is not None and pmesh.n_ranks(mesh) > 1
    try:
        for b0 in range(0, n_labels, lb_max):
            lb = min(lb_max, n_labels - b0)
            wt = _wt_view(w, b0, lb, vocab)
            s_view = (s_blk if lb == lb_max else
                      FlashArray(s_blk.store, (docs, lb), np.float32, "R",
                                 ld=lb_max, ctx=ctx))
            if mesh is not None:  # S_b = A @ W_b^T, row-sharded
                from ..parallel import csrmm_sharded
                csrmm_sharded(a, wt, s_view, mesh=mesh, ctx=ctx)
            else:  # one card's out-of-core pass
                csrmm(a, wt, s_view, ctx=ctx)
            if merges:
                first = b0 == 0
                lab_ids = np.arange(b0, b0 + lb, dtype=np.int32)
                for r0 in range(0, docs, db):
                    bn = min(db, docs - r0)
                    s_new = s_view.read_block(r0, bn, 0, lb)
                    _merge_topk(scores, labels, r0, s_new,
                                np.broadcast_to(lab_ids, (bn, lb)), k, first)
            if waits:
                pmesh.barrier()  # rank 0 has read this block's s_blk
        scores.store.flush()
        labels.store.flush()
        LOG.debug("xml_rank: %d docs x %d labels top-%d in %.0f ms "
                  "(%d label blocks)", docs, n_labels, k,
                  timer.elapsed_ms(), -(-n_labels // lb_max))
        return scores, labels
    finally:
        if mesh is None:
            flash_free(s_blk)
        else:
            pmesh.shared_free(s_blk, mesh)  # after every rank's merge


def xml_rank_in_mem(a_sp, w_np: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Golden model: dense scores + full argsort (the in-memory twin's
    role, reference test strategy SURVEY §4.2)."""
    s = np.asarray(a_sp @ w_np.T, dtype=np.float32)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    rows = np.arange(s.shape[0])[:, None]
    return s[rows, order], order.astype(np.int32)
