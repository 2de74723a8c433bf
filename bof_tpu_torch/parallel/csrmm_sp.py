"""Sharded out-of-core sparse x dense matmul over the mesh, on torch.

The port of `bof_tpu/parallel/csrmm_sp.py`: the csrmm block product
distributed row-wise over every rank of the mesh.  Layout:

    B column panel: replicated              ()
    ELL block (ja/vals): rows sharded       (("x", "y"), None)
    C row slice: rows sharded               (("x", "y"), None)

Sparse rows are independent, so no collective runs in the product: each
rank runs kernel K2 (`sparse/spmm_cuda.py:spmm_ell`) on its row shard
against the replicated B panel.

A world of one rank reads whole row blocks and bands their rows by count
(bof_tpu's single-process path), through the sparse layer's `ell_bands`
and the one-card csrmm's `spmm_bands`.  In a larger world each rank reads
only the nnz ranges of its own ELL row shards and writes back only its own
C rows (bof_tpu's multi-host branch), so the caller's C must be one file
every rank sees; a barrier ends the call once every rank's rows are on
disk.  Every rank computes the same ELL dimensions from the host-resident
offsets, so the shards agree.
"""
from __future__ import annotations

import numpy as np
import torch


def sharded_spmm_step(mesh):
    """step(b_panel, ja, va, counts) -> this rank's rows of the product:
    K2 on the rank's row shard (ja/va its (rows, rmax) ELL rows, counts
    their real slots) against the replicated B panel.  bof_tpu's step
    takes the global ELL block and shards it; here each rank uploads only
    its own rows, so the step is K2 on them."""
    from ..sparse.spmm_device import spmm_ell_block

    def step(b_panel, ja_loc, va_loc, counts):
        return spmm_ell_block(b_panel, ja_loc, va_loc, counts=counts)

    return step


def csrmm_sharded(a, b, c, alpha: float = 1.0, beta: float = 0.0,
                  mesh=None, ctx=None) -> None:
    """C = alpha * A B + beta * C with flash-resident CSR A, every block
    product row-sharded over the mesh.  B column panels must fit the
    device replicated (project-to-low-dim workloads, paper Table 3
    shape)."""
    from ..context import get_context
    from ..core.flash_array import check_output_distinct
    from ..core.pipeline import PrefetchSeq, TicketWindow
    from ..core.tiled_array import reject_tiled
    from ..ops import device as dev
    from ..sparse import spmm_device as sdev
    from ..sparse.csr import fill_row_blocks
    from ..sparse.csrmm import _download_rows, spmm_bands
    from . import mesh as pmesh

    ctx = ctx or b.ctx or get_context()
    cfg = ctx.config
    mesh = mesh or pmesh.make_mesh(device=cfg.device)
    device = pmesh.mesh_device(mesh)
    n_dev = pmesh.n_ranks(mesh)

    m, k = a.shape
    if b.shape[0] != k or c.shape != (m, b.shape[1]):
        raise ValueError("operand shapes inconsistent")
    check_output_distinct(c, b=b, ia=a.ia, ja=a.ja, vals=a.vals)
    reject_tiled((("b", b), ("c", c)),
                 "csrmm_sharded's row blocks are nnz-adaptive and cannot "
                 "align to a tile grid; use flat operands (the single-"
                 "host csrmm handles tile-major C via RMW windows)")
    n = b.shape[1]

    ia_np = a.read_ia()
    blocks = fill_row_blocks(ia_np, cfg.max_nnzs)
    cb = min(n, cfg.csrmm_cblk_size)
    entry_cap = max(1 << 14, int(cfg.hbm_budget // 6 // (cb * 4)))
    cache = ctx.pin_cache()
    idt, vdt = a.ja.dtype, a.vals.dtype
    if not dev.dtype_native_on_device(vdt):
        raise ValueError(
            f"csrmm_sharded is device compute; {vdt} would be silently "
            "narrowed by the fp32 kernels — use csrmm (host block "
            "products)")
    # link dtypes: deterministic in (global panel height, config), so
    # every rank builds dtype-identical shards
    ell_idt = sdev.ell_idx_dtype(k, cfg.ell_idx_narrow)
    ell_vdt = sdev.ell_val_dtype(vdt, cfg)
    step = sharded_spmm_step(mesh)

    accesses = []
    for r, e in blocks:
        i0, i1 = int(ia_np[r]), int(ia_np[e])
        accesses.append((a.ja.store,) + a.ja.block_access(i0, i1 - i0))
        accesses.append((a.vals.store,) + a.vals.block_access(i0, i1 - i0))

    sharded_reads = n_dev > 1 or pmesh._FORCE_SHARDED_READS
    # rows_pad divides over the ranks and stays a multiple of 8: lcm, not
    # max (max(8, 6) = 8 does not divide over 6 ranks)
    min_rows = int(np.lcm(8, n_dev))
    if sharded_reads:
        shard_flat: list = []
        sub_plans = []  # per block: [(s0, s1, rmax, p0, p1, lo, hi, pidx)]
        for (r, e) in blocks:
            i0 = int(ia_np[r])
            blk_ia = ia_np[r:e + 1] - i0
            counts = np.diff(blk_ia)
            subs = []
            for (s0, s1) in sdev.ell_row_ranges(counts, entry_cap):
                rows_pad, rmax = sdev.ell_dims(counts[s0:s1], min_rows)
                p0, p1 = pmesh.row_shard(mesh, rows_pad)
                lo_row, hi_row = s0 + p0, s0 + min(p1, s1 - s0)
                pidx = None
                if hi_row > lo_row:
                    nz_lo, nz_hi = int(blk_ia[lo_row]), int(blk_ia[hi_row])
                    if nz_hi > nz_lo:
                        pidx = len(shard_flat)
                        shard_flat.append((a.ja.store,) + a.ja.block_access(
                            i0 + nz_lo, nz_hi - nz_lo))
                        shard_flat.append((a.vals.store,)
                                          + a.vals.block_access(
                                              i0 + nz_lo, nz_hi - nz_lo))
                subs.append((s0, s1, rmax, p0, p1, lo_row, hi_row, pidx))
            sub_plans.append(subs)

    def finish(rows0: int, c0: int, bc: int, piece: np.ndarray):
        """alpha, beta and C's order on the host, then the async write of
        C rows [rows0, rows0 + len(piece)) x [c0, c0 + bc) (through c_w,
        the rank's writer of C)."""
        data = piece if alpha == 1.0 else piece * np.dtype(vdt).type(alpha)
        if beta != 0.0:
            data = data + beta * c.read_block(rows0, len(piece), c0, bc)
        if c.order != "R":
            data = data.T
        return c_w.write_block_storage_async(rows0, c0, len(piece), bc,
                                             np.ascontiguousarray(data, vdt))

    # each rank writes only its own rows: through `shard_writer`, so that
    # neighbouring ranks' rows in one sector never race
    with pmesh.shard_writer(c, mesh) as c_w:
        write_tickets = TicketWindow(depth=8)
        for c0 in range(0, n, cb):
            bc = min(cb, n - c0)
            b_host = b.read_block(0, k, c0, bc)
            b_pad = np.zeros((k, cb), b.dtype) if bc < cb else b_host
            if bc < cb:
                b_pad[:, :bc] = b_host
            b_dev = dev.to_device(np.ascontiguousarray(b_pad), device)
            pf = PrefetchSeq(cache,
                             shard_flat if sharded_reads else accesses,
                             depth=2 * cfg.pipeline_depth)
            try:
                for bi, (r, e) in enumerate(blocks):
                    i0 = int(ia_np[r])
                    rows_b = e - r
                    blk_ia = ia_np[r:e + 1] - i0
                    if sharded_reads:
                        for (s0, s1, rmax, p0, p1, lo, hi,
                             pidx) in sub_plans[bi]:
                            if hi <= lo:
                                continue  # this rank's shard is row padding
                            if pidx is not None:
                                ja_s = pf.get(pidx).view(idt)
                                va_s = pf.get(pidx + 1).view(vdt)
                            else:  # real rows, all empty
                                ja_s = np.zeros(0, idt)
                                va_s = np.zeros(0, vdt)
                            sub_ia = blk_ia[lo:hi + 1]
                            ja_e, va_e = sdev.to_ell(
                                sub_ia, ja_s, va_s, rmax=rmax,
                                rows_pad=p1 - p0, idx_dtype=ell_idt,
                                val_dtype=ell_vdt)
                            if pidx is not None:
                                pf.done(pidx)
                                pf.done(pidx + 1)
                            up = sdev.upload_band(
                                sdev.EllBand(None,
                                             np.diff(sub_ia).astype(np.int32),
                                             ja_e, va_e),
                                device, 0, hi - lo, with_rows=False)
                            out = step(b_dev, up.ja, up.va, up.counts)
                            del up
                            write_tickets.push(finish(
                                r + lo, c0, bc, dev.from_device(out)[:, :bc]))
                        continue
                    # one rank: csrmm's count-sorted bands, K2 writing
                    # each band's rows of the block's buffer (the per-rank
                    # reads above take contiguous nnz ranges, which sorted,
                    # scattered rows would fragment)
                    bands = sdev.ell_bands(blk_ia, pf.get(2 * bi).view(idt),
                                           pf.get(2 * bi + 1).view(vdt),
                                           entry_cap, cfg, ell_idt, ell_vdt)
                    out_dev = torch.empty((rows_b, cb), dtype=torch.float32,
                                          device=device)
                    spmm_bands(b_dev, bands, out_dev)
                    pf.done(2 * bi)
                    pf.done(2 * bi + 1)
                    for p0, piece in _download_rows(out_dev, bc, False):
                        write_tickets.push(finish(r + p0, c0, bc, piece))
                    del out_dev
            finally:
                pf.close()
        write_tickets.wait_all()
    c.store.flush()
    if n_dev > 1:
        pmesh.barrier()  # every rank's C rows are on disk
