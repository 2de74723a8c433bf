"""Data-parallel Lloyd steps over the mesh, on torch.

The port of `bof_tpu/parallel/kmeans_dp.py`: the Lloyd block step of
ops/kmeans.py sharded point-wise over every rank of the mesh.  Each rank
runs kernel pair B7 (`ops/kmeans.py:lloyd_assign`, `lloyd_accumulate`)
on its own point rows, and one all-reduce a block sums the per-center
sums, the counts and the inertia over the ranks; the centers stay
replicated.

bof_tpu pads each shard to a common shape and masks the pad rows with
zero weights.  B7 takes no weights, so here a rank passes only its real
rows: a pad row never reaches a center.  A world of one rank reads whole
point blocks; in a larger world each rank reads and writes back only the
point and label rows it owns (bof_tpu's multi-host branch), so the
caller's `labels_out` must be one file every rank sees.  The resident
tier keeps the blocks a rank would stream on its card for the whole fit,
at any world size (bof_tpu keeps it to one process), so both tiers do
the same arithmetic; the statistics are all-reduced either way, so every
rank folds the same centers.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..utils import METRICS
from . import mesh as pmesh


def dp_lloyd_step(mesh, prec: str = "highest"):
    """Returns step(p_loc, p_norm2, centers) -> (sums, counts, inertia,
    labels) for this rank's point rows p_loc (bn, d) fp32 on its device,
    their sum of |p|^2 and the replicated centers (k, d) host fp32: B7 on
    the rank's rows, then one all-reduce of the statistics over every
    rank.  sums (k, d) float64, counts (k,) float64 and the inertia (the
    rows' min distances plus their |p|^2, float) are the whole mesh's;
    labels (bn,) int32 are the rank's rows'.  `prec` is bof_tpu's; B7 is
    3xTF32 at every tier."""
    from ..ops.kmeans import _DeviceStep
    device = pmesh.mesh_device(mesh)

    def step(p_loc: torch.Tensor, p_norm2: float, centers: np.ndarray):
        st = _DeviceStep(centers, device)
        labels = (st.block(p_loc) if p_loc.shape[0]
                  else torch.zeros(0, dtype=torch.int32, device=device))
        return _reduce(st, p_norm2) + (labels,)

    return step


def _reduce(st, p_norm2: float):
    """All-reduce one `_DeviceStep`'s statistics over every rank: (sums,
    counts, inertia) as float64 host values."""
    k, d = st.sums.shape
    flat = torch.cat([st.sums.reshape(-1).to(torch.float64),
                      st.counts.to(torch.float64),
                      (st.mind_sum + p_norm2).reshape(1)])
    pmesh.all_reduce(flat)
    flat = flat.cpu().numpy()
    return flat[:k * d].reshape(k, d), flat[k * d:k * d + k], float(flat[-1])


def _new_centers(sums, counts, centers):
    safe = np.maximum(counts, 1.0)[:, None]
    return np.where(counts[:, None] > 0, sums / safe,
                    centers).astype(np.float32)


def _norm2(p: np.ndarray) -> float:
    return float(np.einsum("ij,ij->", p, p, dtype=np.float64))


def lloyds_iter_sharded(points_np: np.ndarray, centers: np.ndarray,
                        mesh=None, prec: str = "highest"):
    """One data-parallel Lloyd iteration over host-resident points (every
    rank holds them; each uploads its own rows).  Returns (new_centers,
    inertia, counts)."""
    from ..ops import device as dev

    mesh = mesh or pmesh.make_mesh()
    if points_np.dtype == np.float64:
        raise ValueError(
            "sharded Lloyd computes in float32 and cannot represent "
            "float64 points exactly; use ops.kmeans.lloyds_iter for fp64")
    centers = np.ascontiguousarray(centers, np.float32)
    lo, hi = pmesh.row_run(mesh, points_np.shape[0])[:2]
    p = np.ascontiguousarray(points_np[lo:hi], np.float32)
    sums, counts, inertia, _ = dp_lloyd_step(mesh, prec)(
        dev.to_device(p, pmesh.mesh_device(mesh)), _norm2(p), centers)
    return _new_centers(sums, counts, centers), inertia, counts


def _write_rank_labels(labels_out, lo: int, lab: torch.Tensor, tickets):
    from ..ops import device as dev
    from ..ops.kmeans import _write_labels
    if lab.shape[0]:
        _write_labels(labels_out, lo, np.ascontiguousarray(
            dev.from_device(lab), np.int32), tickets)


def _rank_blocks(mesh, n: int, d: int, blk_rows: Optional[int]):
    """The streamed pass's blocks as this rank reads them: [(lo, hi)] per
    block of `blk_rows` rows (64 MiB of float32 points by default,
    rounded to a multiple of the ranks), the rank's run of each (the
    whole block in a world of one rank)."""
    n_dev = pmesh.n_ranks(mesh)
    blk = blk_rows or max(1, min(n, (64 << 20) // max(4 * d, 1)))
    blk = ((blk + n_dev - 1) // n_dev) * n_dev  # shards stay uniform
    return [tuple(r0 + x for x in pmesh.row_run(mesh, min(blk, n - r0))[:2])
            for r0 in range(0, n, blk)]


def _lloyd_pass(mesh, step, blocks, centers, labels_out):
    """One Lloyd pass over `blocks`, an iterable of (lo, hi, p_dev,
    p_norm2): the step a block, its statistics folded in float64 on the
    host, the labels of rows [lo, hi) written where asked.  Returns
    (new_centers, inertia, counts)."""
    from ..core.pipeline import TicketWindow
    kc, d = centers.shape
    sums = np.zeros((kc, d), np.float64)
    counts = np.zeros(kc, np.float64)
    inertia = 0.0
    with contextlib.ExitStack() as stack:
        # each rank writes only its own label rows (`shard_writer`)
        lab_w = None if labels_out is None else stack.enter_context(
            pmesh.shard_writer(labels_out, mesh))
        write_tickets = TicketWindow(depth=8)
        stack.callback(write_tickets.wait_all)
        for lo, hi, p_dev, norm2 in blocks:
            s, c, i, labels = step(p_dev, norm2, centers)
            sums += s
            counts += c
            inertia += i
            if lab_w is not None:
                _write_rank_labels(lab_w, lo, labels, write_tickets)
    if labels_out is not None:
        labels_out.store.flush()
        if pmesh.n_ranks(mesh) > 1:
            pmesh.barrier()  # every rank's label rows are on disk
    return _new_centers(sums, counts, centers), inertia, counts


def _upload(p_host: np.ndarray, device):
    """(the block on the card in fp32, its sum of |p|^2)."""
    from ..ops import device as dev
    p_dev = dev.to_device(p_host.astype(np.float32, copy=False), device)
    METRICS.add("kmeans.h2d_bytes", p_dev.nbytes)
    return p_dev, _norm2(p_host)


def lloyds_iter_ooc_sharded(points, centers: np.ndarray,
                            labels_out=None, mesh=None,
                            blk_rows: Optional[int] = None,
                            prec: str = "highest", ctx=None):
    """One Lloyd iteration over FLASH-resident points, each streamed block
    data-parallel over the mesh (ops/kmeans.lloyds_iter's structure with
    `dp_lloyd_step` as the device step): blocks prefetch through the pin
    cache, each rank reading its own rows; the statistics all-reduce a
    block and accumulate on the host.  Returns (new_centers, inertia,
    counts)."""
    from ..context import get_context
    from ..core.pipeline import PrefetchSeq

    ctx = ctx or points.ctx or get_context()
    cfg = ctx.config
    mesh = mesh or pmesh.make_mesh(device=cfg.device)
    device = pmesh.mesh_device(mesh)
    n, d = points.shape
    _check_points(points)
    centers = np.ascontiguousarray(centers, np.float32)
    rows = _rank_blocks(mesh, n, d, blk_rows)
    reads = [(lo, hi) for lo, hi in rows if hi > lo]
    pf = PrefetchSeq(ctx.pin_cache(),
                     [(points.store,) + points.block_access(lo, hi - lo, 0, d)
                      for lo, hi in reads], depth=cfg.pipeline_depth)

    def blocks():
        j = 0
        for lo, hi in rows:
            if hi <= lo:  # this rank's run of a short last block is empty
                yield (lo, hi) + _upload(np.zeros((0, d), np.float32),
                                         device)
                continue
            p_host = pf.get(j).view(points.dtype).reshape(hi - lo, d)
            yield (lo, hi) + _upload(p_host, device)
            pf.done(j)
            j += 1
    try:
        return _lloyd_pass(mesh, dp_lloyd_step(mesh, prec), blocks(),
                           centers, labels_out)
    finally:
        pf.close()


def _check_points(points) -> None:
    if points.order != "R":
        raise ValueError("points must be row-major (one point per row)")
    if points.dtype == np.float64:
        raise ValueError(
            "sharded Lloyd computes in float32 and cannot represent "
            "float64 points exactly; use ops.kmeans.lloyds_iter / "
            "kmeans_fit (exact host step) for fp64")


def kmeans_fit_sharded(points, n_centers: int, n_iters: int = 10,
                       seed: int = 0, tol: float = 1e-4, labels_out=None,
                       mesh=None, ctx=None):
    """Full out-of-core Lloyd's over the mesh (the multi-card analog of
    ops/kmeans.kmeans_fit).  Seeds with bof_tpu's sampled k-means++ on
    the host, the same bits on every rank.  Returns (centers, inertia).

    Device tier (as bof_tpu's): when the point panel fits the mesh's
    aggregate device budget, each rank uploads the rows it would stream
    (the same blocks) ONCE and every iteration runs over them on the
    card, so both tiers do the same arithmetic."""
    from ..context import get_context
    from ..ops.kmeans import _kmeanspp_sample

    ctx = ctx or getattr(points, "ctx", None) or get_context()
    cfg = ctx.config
    mesh = mesh or pmesh.make_mesh(device=cfg.device)
    n_dev = pmesh.n_ranks(mesh)
    n, d = points.shape
    if points.dtype == np.float64:
        raise ValueError(
            "kmeans_fit_sharded computes in float32 and cannot represent "
            "float64 points exactly; use ops.kmeans.kmeans_fit (exact "
            "host Lloyd step) for fp64")
    k = n_centers
    rng = np.random.default_rng(seed)
    centers = _kmeanspp_sample(points, n_centers, rng)

    resident = None
    if (points.order == "R" and n_iters > 1
            # sharded panel + one-hot per device, against aggregate budget
            and 3 * n * (d + k) * 4 <= cfg.hbm_budget * n_dev
            # the upload stages one full float32 panel in host DRAM
            and n * d * 4 <= cfg.program_budget):
        device = pmesh.mesh_device(mesh)
        resident = [(lo, hi) + _upload(
            points.read_block(lo, hi - lo, 0, d) if hi > lo
            else np.zeros((0, d), np.float32), device)
            for lo, hi in _rank_blocks(mesh, n, d, None)]
    step = dp_lloyd_step(mesh, cfg.matmul_precision)

    def one_iter(c_np, want_labels):
        out = labels_out if want_labels else None
        if resident is None:
            return lloyds_iter_ooc_sharded(points, c_np, labels_out=out,
                                           mesh=mesh, ctx=ctx)
        return _lloyd_pass(mesh, step, resident,
                           np.ascontiguousarray(c_np, np.float32), out)

    prev = None
    inertia = 0.0
    for it in range(n_iters):
        last = it == n_iters - 1
        centers, inertia, _ = one_iter(centers, want_labels=last)
        if prev is not None and abs(prev - inertia) <= tol * max(prev, 1.0):
            if labels_out is not None and not last:
                _, inertia, _ = one_iter(centers, want_labels=True)
            break
        prev = inertia
    return centers, inertia
