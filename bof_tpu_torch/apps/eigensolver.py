"""Out-of-core spectral solvers over flash-resident sparse matrices.

The port of `bof_tpu/apps/eigensolver.py` (the NSDI'19 paper's Table 4
application: a block Krylov-Schur eigensolver on bag-of-words matrices),
built, as there, from the library's sparse kernels with host
orthogonalization.  Two solvers:

- `block_lanczos_svd`: block Lanczos with full reorthogonalization and
  thick (Krylov-Schur style) restarts on the A^T A operator, checkpointable
  in bof_tpu's `.npz` format, so a state either package wrote resumes in
  the other;
- `block_power_svd`: block subspace iteration, the baseline.

Both reach U = A^T (A V) through `apply_gram`, one operator application:
either one streaming pass over A (`_apply_ata_one_pass`, the default) or
csrcsc + two csrmm passes (the reference's 'T' dispatch structure,
csrmm.cpp:364-420).  On the card the one-pass operator runs both halves
of every ELL band as kernel K2 (`_apply_ata_one_pass_device`, bof_tpu's
B9 step): W = A_band V lands in a device buffer of exactly the band's
rows, the band's transpose over the words it touches (built on the host)
multiplies W, and each U partial is added into a float64 U on the card,
which comes down once an application.  The host algebra is bof_tpu's,
line for line.

With `mesh=` (a `DeviceMesh`, parallel.make_mesh) every operator
application runs row-sharded over the mesh's ranks: by default as two
`csrmm_sharded` passes, or with one_pass=True as the one streaming pass
with both halves sharded (`_apply_ata_one_pass_sharded`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..context import get_context
from ..core.flash_array import flash_empty, flash_free, mem_array
from ..ops import device as dev
from ..sparse import CsrFlashMatrix, csrcsc_scratch, csrmm
from ..utils import LOG, METRICS, Timer


def _apply_ata_one_pass(a: CsrFlashMatrix, v_np: np.ndarray,
                        ctx) -> np.ndarray:
    """U = A^T (A V) in ONE streaming pass over A's row blocks: A's bytes
    cross the disk once per operator application, and neither the (m x b)
    panel nor the transpose is ever materialized.

    Honors FlashConfig.sparse_compute: 'host' runs both block products as
    scipy on the pinned tile (the reference's MKL-on-host model), 'device'
    runs both on the card (`_apply_ata_one_pass_device`), 'auto' places by
    the measured link rate, as csrmm does.  fp64 values always take the
    exact host path (the device kernels are fp32)."""
    mode = getattr(ctx.config, "sparse_compute", "host")
    if not dev.dtype_native_on_device(a.vals.dtype):
        mode = "host"
    if mode == "auto":
        link = dev.link_gbps_estimate(dev.resolve_device(ctx.config.device))
        if link >= 1.0:
            mode = "device"
        else:
            b = v_np.shape[1]
            nnz = float(a.nnz)
            # device ships forward ELL + transposed ELL (~2x nnz*(4+4)
            # padded) + V up and U partials down; host runs two scipy
            # products per block in place
            t_dev = (2 * nnz * 16.0 + 2 * a.shape[1] * b * 4.0) / (link * 1e9)
            t_host = 2.0 * (2.0 * nnz * b) / 2.0e9
            mode = "host" if t_host < t_dev else "device"
    if mode == "device":
        return _apply_ata_one_pass_device(a, v_np, ctx)
    import scipy.sparse as sps

    from ..sparse.csr import fill_row_blocks, stream_row_blocks

    cfg = ctx.config
    m, k = a.shape
    ia_np = a.read_ia()
    blocks = fill_row_blocks(ia_np, cfg.max_nnzs)
    v32 = np.ascontiguousarray(v_np, np.float32)
    U = np.zeros((k, v32.shape[1]), np.float64)
    for r, e, ja_blk, va_blk in stream_row_blocks(a, ia_np, blocks, ctx):
        blk = sps.csr_matrix(
            (va_blk, ja_blk.astype(np.int64),
             (ia_np[r:e + 1] - int(ia_np[r])).astype(np.int64)),
            shape=(e - r, k))
        w_rb = blk @ v32                     # (rows, b)
        U += blk.T @ w_rb                    # (k, b) accumulate
    METRICS.add("eig.op_applies")
    return U


FOLD_BYTES = 64 << 20  # float64 bytes of a partial the fold widens at once


def _trim_freed() -> None:
    """Hand the heap's free pages back to the kernel (glibc's
    `malloc_trim`).  The band threads free gigabytes of arrays a call on
    their own arenas, and glibc keeps an arena's freed pages mapped up to
    its trim threshold; returned before U's host array is mapped, they
    leave the call's peak at what is live.  Changes no setting of the
    allocator; nothing where the C library is not glibc."""
    import ctypes
    try:
        trim = ctypes.CDLL("libc.so.6").malloc_trim
    except (OSError, AttributeError):
        return
    trim.argtypes = (ctypes.c_size_t,)
    trim(0)


def _populated(shape) -> np.ndarray:
    """A new float64 host array whose pages the kernel maps in one go
    (MAP_POPULATE) where it can, rather than one fault at a time under
    the copy that first writes them (U is 3.6 GB at the eig_large cell's
    widths; PERF.md §6)."""
    import mmap
    nbytes = int(np.prod(shape)) * 8
    flag = getattr(mmap, "MAP_POPULATE", 0)
    if not nbytes or not flag:
        return np.empty(shape, np.float64)
    buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                    | flag)
    return np.frombuffer(buf, np.float64).reshape(shape)


def _gram_entry_cap(hbm_budget: int, k: int, b: int) -> int:
    """ELL entries a band may hold.  V (k x b fp32) and U (k x b float64)
    stay on the card for the whole application, 12 k b bytes; a band's W
    and a column band's partial, at most entry_cap x b fp32 each, live
    beside them.  The library's sixth of `hbm_budget` a band output, as
    csrmm's, unless that leaves the two less than what V and U leave."""
    room = min(hbm_budget // 6, (hbm_budget - 12 * k * b) // 2)
    return max(1 << 14, int(room // (b * 4)))


def _band_columns(blk_ia, ja_blk, va_blk, rows_sel, counts, k: int):
    """The transpose of rows `rows_sel` of a row block (`blk_ia` its
    offsets from 0, `counts` their np.diff) over only the words they
    hold: (words, ia, ja, va), `words` the touched columns ascending, and
    a CSR over them whose row j lists word words[j]'s entries: `ja` their
    positions within rows_sel (W's rows), ascending, and `va` their
    values.  scipy's CSC of the selection builds a k + 1 column pointer;
    every plan, band and partial after it is over the touched words
    alone."""
    import scipy.sparse as sps
    n = counts[rows_sel]
    sub_ia = np.zeros(len(rows_sel) + 1, np.int64)
    np.cumsum(n, out=sub_ia[1:])
    pos = (np.repeat(blk_ia[rows_sel] - sub_ia[:-1], n)
           + np.arange(sub_ia[-1], dtype=np.int64))
    csc = sps.csr_matrix((va_blk[pos], ja_blk[pos], sub_ia),
                         shape=(len(rows_sel), k)).tocsc()
    words = np.flatnonzero(csc.indptr[1:] != csc.indptr[:-1])
    ia = np.append(csc.indptr[words], csc.indptr[-1]).astype(np.int64)
    return words, ia, csc.indices.astype(np.int64), csc.data


def _one_pass_stream(a: CsrFlashMatrix, v_np: np.ndarray, ctx, device,
                     fwd_product, t_product, finalize=None) -> np.ndarray:
    """The one-pass device operator's loop (bof_tpu's B9 step with its
    planner), shared by the one-card and the sharded operators: stream
    nnz-budgeted row blocks, band each block's rows by count (count-sorted
    ELL banding), transpose each band on the host over the words it
    touches (`_band_columns`; the block is already in DRAM) and band
    those words the same way, a block's bands on the host's cores
    (`utils/hostpar.fanout_threads`).  Per band (an `EllBand`), in band
    order, `fwd_product(v_dev, band)` gives W_sub = A_sub V on the card
    (a row a band row), and per column band `t_product(w, cband)` gives
    (rows, u): u the fp32 rows of A_sub^T W_sub that this rank computed,
    on the card, and `rows` their words there (None for none).  Each u
    is added into a float64 U on the card (`U.index_add_`, a band's
    words distinct, in band order: the host fold's additions, bit for
    bit); `finalize(U)`, where given, completes U on the card in place
    (the sharded operator's all-reduce), and U comes down once, through
    the context's page-locked ring.

    Link dtypes follow FlashConfig.transfer_dtype as csrmm's bands do
    (bf16 values, or int8 with a scale an ELL row); fp32 by default.
    Spans: `eig.disk_wait` (A's next block), `eig.prep` (forward
    banding), `eig.transpose` (the band's columns, their plan and bands),
    `eig.band_wait` (the launching thread waiting for the pool's next
    band), `eig.h2d` (V and the bands, with bytes), `eig.dispatch` (K2,
    both halves), `eig.fold`, `eig.d2h` (U, with bytes), `eig.write`
    (U's host array: its pages, the copies out of the ring); counters
    `eig.fwd_bands`, `eig.t_bands`, `eig.t_rows` (the words of every
    column band), `eig.band_threads` (the pool's threads, summed over
    applications: `eig.prep_s` and `eig.transpose_s` are those threads'
    seconds), `eig.op_applies`."""
    from concurrent.futures import ThreadPoolExecutor

    from ..sparse import spmm_device as sdev
    from ..sparse.csr import fill_row_blocks, stream_row_blocks
    from ..utils.hostpar import fanout_threads

    cfg = ctx.config
    k = a.shape[1]
    ia_np = a.read_ia()
    blocks = fill_row_blocks(ia_np, cfg.max_nnzs)
    v32 = np.ascontiguousarray(v_np, np.float32)
    with METRICS.span("eig.h2d", v32.nbytes):
        v_dev = dev.to_device(v32, device)
    b = v_dev.shape[1]
    entry_cap = _gram_entry_cap(cfg.hbm_budget, k, b)
    sort_rows = getattr(cfg, "ell_sort_rows", True)
    narrow = getattr(cfg, "ell_idx_narrow", True)
    fwd_idt = sdev.ell_idx_dtype(k, narrow)  # forward panel height = k
    val_dt = sdev.ell_val_dtype(a.vals.dtype, cfg)
    quant = sdev.ell_val_quantize(a.vals.dtype, cfg)
    fold_rows = max(1, FOLD_BYTES // (8 * b))

    def bands(blk_ia, ja_blk, va_blk, counts, rows_sel):
        """A band of the block and the column bands of its transpose;
        the transpose's rows are positions within rows_sel, exactly W's
        rows, and its words always band count-sorted."""
        with METRICS.span("eig.prep"):
            band = sdev.build_band(blk_ia, ja_blk, va_blk, rows_sel, counts,
                                   fwd_idt, val_dt, quant)
        with METRICS.span("eig.transpose"):
            words, t_ia, t_ja, t_va = _band_columns(blk_ia, ja_blk, va_blk,
                                                    rows_sel, counts, k)
            t_counts = np.diff(t_ia)
            corder, cranges = sdev.band_plan(t_counts, entry_cap)
            t_idt = sdev.ell_idx_dtype(len(rows_sel), narrow)
            cbands = []
            for c0, c1 in cranges:
                if c1 == c0:
                    continue  # a band of rows that hold no word
                cband = sdev.build_band(t_ia, t_ja, t_va, corder[c0:c1],
                                        t_counts, t_idt, val_dt, quant)
                cbands.append(cband._replace(
                    rows=words[cband.rows].astype(np.int32)))
        return band, cbands

    U = torch.zeros((k, b), dtype=torch.float64, device=device)
    threads = fanout_threads(max(
        (int(ia_np[e] - ia_np[r]) for r, e in blocks), default=0))
    METRICS.add("eig.band_threads", threads)
    with ThreadPoolExecutor(threads) as pool:
        for r, e, ja_blk, va_blk in stream_row_blocks(
                a, ia_np, blocks, ctx, wait_span="eig.disk_wait"):
            with METRICS.span("eig.prep"):
                blk_ia = ia_np[r:e + 1] - int(ia_np[r])
                counts = np.diff(blk_ia)
                order, ranges = sdev.band_plan(counts, entry_cap, sort_rows)
            # the block's bands are formed on the pool's threads and
            # launched in band order, so U's additions keep it
            formed = pool.map(lambda s: bands(blk_ia, ja_blk, va_blk,
                                              counts, order[s[0]:s[1]]),
                              ranges)
            for _ in ranges:
                with METRICS.span("eig.band_wait"):
                    band, cbands = next(formed)
                METRICS.add("eig.fwd_bands")
                w = fwd_product(v_dev, band)
                del band
                for cband in cbands:
                    METRICS.add("eig.t_bands")
                    METRICS.add("eig.t_rows", len(cband.counts))
                    rows, u = t_product(w, cband)
                    if rows is None:
                        continue
                    with METRICS.span("eig.fold"):
                        for f0 in range(0, len(rows), fold_rows):
                            U.index_add_(0, rows[f0:f0 + fold_rows],
                                         u[f0:f0 + fold_rows].double())
                    del rows, u
                del w, cbands
    del v_dev
    _trim_freed()
    if finalize is not None:
        finalize(U)
    out = _download_u(U, ctx)
    METRICS.add("eig.op_applies")
    return out


def _upload(band, device, lo, hi, with_rows=False):
    """Rows [lo, hi) of a band on `device` (and their words where
    `with_rows`)."""
    from ..sparse import spmm_device as sdev
    with METRICS.span("eig.h2d") as sp:
        up = sdev.upload_band(band, device, lo, hi, with_rows=with_rows)
        sp.nbytes = up.nbytes
    return up


def _k2(panel, up, impl="auto"):
    """K2 on an uploaded band against `panel`, each row's real slots."""
    from ..sparse import spmm_device as sdev
    with METRICS.span("eig.dispatch"):
        return sdev.spmm_ell_block_dispatch(panel, up.ja, up.va, impl,
                                            counts=up.counts,
                                            va_scale=up.va_scale)


def _download_u(u_dev, ctx) -> np.ndarray:
    """U to the host once, in runs through the context's page-locked
    ring (`eig.d2h` a run, with its bytes), into a new host array: its
    pages mapped and each run copied in under `eig.write`."""
    k, b = u_dev.shape
    with METRICS.span("eig.write"):
        out = _populated((k, b))

    def consume(r0, host):
        with METRICS.span("eig.write"):
            out[r0:r0 + len(host)] = host

    ctx.d2h_ring(u_dev.device).download(dev.Finished(u_dev), lambda t: t,
                                        k, b, consume, "eig")
    return out


def _apply_ata_one_pass_device(a: CsrFlashMatrix, v_np: np.ndarray,
                               ctx) -> np.ndarray:
    """Device variant of the one-pass operator on one card: per band,
    W_sub = A_sub V and U_part = A_sub^T W_sub are both K2 launches on
    exactly the band's rows (each row's real slot count passed, so padding
    is never read); W_sub stays on the card, and each U partial is added
    into the float64 U on the card."""
    device = dev.resolve_device(ctx.config.device)
    impl = getattr(ctx.config, "sparse_device_impl", "auto")

    def fwd(v_dev, band):
        return _k2(v_dev, _upload(band, device, 0, len(band.counts)), impl)

    def trans(w, cband):
        up = _upload(cband, device, 0, len(cband.counts), with_rows=True)
        return up.rows, _k2(w, up, impl)

    return _one_pass_stream(a, v_np, ctx, device, fwd, trans)


def _replicate_step(mesh):
    """rows -> every rank's rows stacked, rank order: bof_tpu's reshard of
    a row-sharded array to replicated, one all-gather."""
    from ..parallel import mesh as pmesh
    n_dev = pmesh.n_ranks(mesh)

    def replicate(x_loc):
        out = x_loc.new_empty((n_dev * x_loc.shape[0],) + x_loc.shape[1:])
        pmesh.all_gather(out, x_loc.contiguous())
        return out

    return replicate


def _apply_ata_one_pass_sharded(a: CsrFlashMatrix, v_np: np.ndarray,
                                mesh, ctx) -> np.ndarray:
    """One-pass U = A^T (A V) with both ELL halves row-sharded over the
    mesh (`_one_pass_stream`'s loop): each band's rows, padded to a
    multiple of the ranks, split into one contiguous run a rank, and K2
    runs on the rank's run (the csrmm_sharded layout); one all-gather
    makes the band's W whole on every rank; the transposed half splits
    the band's words the same way against that W, and each rank adds its
    words' partials into its own float64 U on the card.  Every row of
    every partial is computed by exactly one rank, so one float64
    all-reduce of the card's U at the end sums the ranks' U into the
    operator's value, and A's bytes still cross the disk once per rank
    and application.  fp64 values raise (the kernels are fp32)."""
    from ..parallel import mesh as pmesh

    if not dev.dtype_native_on_device(a.vals.dtype):
        raise ValueError(
            f"sharded one_pass cannot represent {a.vals.dtype} on the "
            "card; use one_pass without a mesh (exact host path)")
    device = pmesh.mesh_device(mesh)
    replicate = _replicate_step(mesh)

    def fwd(v_dev, band):
        lo, hi, run = pmesh.row_run(mesh, len(band.counts))
        w_loc = torch.zeros((run, v_dev.shape[1]), dtype=torch.float32,
                            device=device)
        if hi > lo:
            w_loc[:hi - lo] = _k2(v_dev, _upload(band, device, lo, hi))
        return replicate(w_loc)  # the band's W, whole on every rank

    def trans(w, cband):
        lo, hi, _ = pmesh.row_run(mesh, len(cband.counts))
        if hi <= lo:
            return None, None
        up = _upload(cband, device, lo, hi, with_rows=True)
        return up.rows, _k2(w, up)

    return _one_pass_stream(a, v_np, ctx, device, fwd, trans,
                            pmesh.all_reduce)


def _panel_ops(mesh, ctx):
    """(empty, free, spmm) of the two-pass operator's panels: shared
    panels and csrmm_sharded under a mesh, else scratch files and
    csrmm."""
    if mesh is not None:
        from ..parallel import csrmm_sharded
        from ..parallel.mesh import shared_empty, shared_free
        return (lambda shape: shared_empty(shape, np.float32, mesh, ctx),
                lambda arr: shared_free(arr, mesh),
                lambda mat, x, out: csrmm_sharded(mat, x, out, mesh=mesh,
                                                  ctx=ctx))
    return (lambda shape: flash_empty(shape, np.float32, ctx=ctx),
            flash_free,
            lambda mat, x, out: csrmm(mat, x, out, ctx=ctx))


def _apply_two_pass(a: CsrFlashMatrix, at: CsrFlashMatrix,
                    v_np: np.ndarray, w_panel, mesh, ctx) -> np.ndarray:
    """U = A^T (A V) as two out-of-core csrmm passes (csrmm_sharded under
    a mesh) through an (m x w) W panel: `w_panel` where it is w wide,
    else one made for the call; `at` is A^T (csrcsc_scratch).  U is read
    whole after every rank wrote its rows: a shared panel under a mesh,
    host memory on one card."""
    m, k = a.shape
    w = v_np.shape[1]
    empty, free, spmm = _panel_ops(mesh, ctx)
    Vp = mem_array((k, w), np.float32, data=v_np.astype(np.float32),
                   ctx=ctx)
    Wp = (w_panel if w_panel is not None and w_panel.shape[1] == w
          else empty((m, w)))
    Up = (empty((k, w)) if mesh is not None
          else mem_array((k, w), np.float32, ctx=ctx))
    try:
        spmm(a, Vp, Wp)
        spmm(at, Wp, Up)
        u = Up.read_all().astype(np.float64)
    finally:
        if Wp is not w_panel:
            free(Wp)
        if mesh is not None:
            free(Up)
    METRICS.add("eig.op_applies")
    return u


@METRICS.span("eig.apply")
def apply_gram(a: CsrFlashMatrix, v: np.ndarray, *,
               one_pass: Optional[bool] = None, mesh=None, ctx=None,
               at: Optional[CsrFlashMatrix] = None,
               w_panel=None) -> np.ndarray:
    """U = A^T (A V), (k, b) float64, for a (k, b) panel V: one operator
    application of `block_lanczos_svd` and `block_power_svd`, which both
    call it.

    `one_pass` (default: on without a mesh, bof_tpu's rule) streams A
    once (`_apply_ata_one_pass`, placed by FlashConfig.sparse_compute;
    with `mesh` both ELL halves row-sharded,
    `_apply_ata_one_pass_sharded`); one_pass=False runs two csrmm passes
    (csrmm_sharded under a mesh) through A^T and an (m x b) W panel:
    `at` and `w_panel` where the caller keeps them across applications,
    else made and freed for this call."""
    ctx = ctx or a.ctx or get_context()
    if one_pass is None:
        one_pass = mesh is None
    if one_pass:
        if mesh is not None:
            return _apply_ata_one_pass_sharded(a, v, mesh, ctx)
        return _apply_ata_one_pass(a, v, ctx)
    own_at = at is None
    if own_at:
        at = csrcsc_scratch(a, ctx=ctx)
    try:
        return _apply_two_pass(a, at, v, w_panel, mesh, ctx)
    finally:
        if own_at:
            for arr in (at.ia, at.ja, at.vals):
                flash_free(arr)


def block_power_svd(a: CsrFlashMatrix, n_vals: int, n_iters: int = 12,
                    seed: int = 0, tol: float = 1e-6,
                    one_pass: Optional[bool] = None, ctx=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Top `n_vals` singular values and right singular vectors of A.

    Returns (sigma (L,) descending, V (k, L)).  Only (k x L) and (L x L)
    host matrices are resident.  `one_pass` (default on) applies A^T A
    in one streaming pass over A; one_pass=False materializes A^T via
    csrcsc and composes two csrmm passes (the reference's 'T' dispatch
    structure, csrmm.cpp:364-420).
    """
    ctx = ctx or a.ctx or get_context()
    m, k = a.shape
    L = n_vals
    rng = np.random.default_rng(seed)
    timer = Timer()

    one_pass = one_pass is None or one_pass
    at = W = None
    if not one_pass:
        at = csrcsc_scratch(a, ctx=ctx)  # A^T, materialized once
        W = flash_empty((m, L), np.float32, ctx=ctx)

    def half_step(v_np):
        return apply_gram(a, v_np, one_pass=one_pass, ctx=ctx, at=at,
                          w_panel=W)

    v_np, _ = np.linalg.qr(rng.standard_normal((k, L)))
    try:
        sigma = np.zeros(L)
        for it in range(n_iters):
            u_np = half_step(v_np)
            g = v_np.T @ u_np                     # Rayleigh quotient
            evals = np.linalg.eigvalsh((g + g.T) / 2)[::-1][:L]
            new_sigma = np.sqrt(np.maximum(evals, 0.0))
            delta = float(np.abs(new_sigma - sigma).max()
                          / (np.abs(new_sigma).max() or 1.0))
            sigma = new_sigma
            v_np, _ = np.linalg.qr(u_np)          # power step
            LOG.debug("svd iter %d: sigma_max %.6g delta %.2e (%.0f ms)",
                      it, sigma[0] if L else 0.0, delta, timer.elapsed_ms())
            if it > 0 and delta < tol:
                break
        # final Rayleigh-Ritz rotation on the converged subspace
        u_np = half_step(v_np)
        g = v_np.T @ u_np
        evals, evecs = np.linalg.eigh((g + g.T) / 2)
        order = np.argsort(evals)[::-1][:L]
        sigma = np.sqrt(np.maximum(evals[order], 0.0))
        v_out = (v_np @ evecs[:, order]).astype(np.float32)
        return sigma, v_out
    finally:
        if W is not None:
            flash_free(W)
        if at is not None:
            for arr in (at.ia, at.ja, at.vals):
                flash_free(arr)


def block_lanczos_svd(a: CsrFlashMatrix, n_vals: int,
                      block_size: Optional[int] = None,
                      max_kdim: Optional[int] = None,
                      n_restarts: int = 8, tol: float = 1e-6,
                      seed: int = 0, state_path: Optional[str] = None,
                      one_pass: Optional[bool] = None,
                      mesh=None, ctx=None) -> Tuple[np.ndarray, np.ndarray]:
    """Top `n_vals` singular values / right singular vectors of A by block
    Lanczos with thick restart on B = A^T A (the paper's block
    Krylov-Schur solver role, Table 4).

    Each operator application is one streaming pass over A (`one_pass`,
    the default) or two out-of-core csrmm passes.  The Krylov basis is
    fully reorthogonalized on the host (k x kdim, kdim <= ~4L).

    `state_path` makes the restart loop checkpointable: each completed
    cycle atomically saves (rnd, panel, theta, Y) in bof_tpu's format,
    and a rerun resumes from the last finished cycle.  The file is
    removed on convergence.

    With `mesh` (parallel.make_mesh), every operator application runs
    row-sharded over the mesh: by default the two csrmm passes
    (`csrmm_sharded`, into W and U panels every rank sees), with an
    explicit one_pass=True the single streaming pass with both ELL halves
    sharded (`_apply_ata_one_pass_sharded`).  The host Krylov algebra is
    unchanged and runs on every rank on the same (replicated) values.

    Returns (sigma (L,) descending, V (k, L))."""
    import os
    ctx = ctx or a.ctx or get_context()
    if n_restarts < 1:
        raise ValueError("n_restarts must be >= 1")
    m, k = a.shape
    L = n_vals
    b = int(block_size or min(max(L, 2), max(2, k // 4)))
    kdim = int(max_kdim or min(k, max(4 * L, 3 * b)))
    rng = np.random.default_rng(seed)
    timer = Timer()

    if one_pass is None:
        one_pass = mesh is None  # bof_tpu's single-process rule
    at = W = None
    if not one_pass:
        at = csrcsc_scratch(a, ctx=ctx)  # A^T, materialized once
        W = _panel_ops(mesh, ctx)[0]((m, b))

    def apply_op(v_np: np.ndarray) -> np.ndarray:
        """B v = A^T (A v), (k, w) -> (k, w) float64."""
        return apply_gram(a, v_np, one_pass=one_pass, mesh=mesh, ctx=ctx,
                          at=at, w_panel=W)

    def orthonormalize(R: np.ndarray, basis: Optional[np.ndarray]):
        """Two-pass block Gram-Schmidt against `basis`, then QR; random
        replacement columns on (near-)breakdown."""
        for _ in range(2):
            if basis is not None and basis.size:
                R = R - basis @ (basis.T @ R)
        Q, Rr = np.linalg.qr(R)
        # detect rank deficiency: tiny diagonal => replace with random dirs
        bad = np.abs(np.diag(Rr)) < 1e-10 * max(1.0, np.abs(Rr).max())
        if bad.any():
            Q[:, bad] = rng.standard_normal((k, int(bad.sum())))
            for _ in range(2):
                if basis is not None and basis.size:
                    Q = Q - basis @ (basis.T @ Q)
                Q, _ = np.linalg.qr(Q)
        return Q

    def save_state(rnd, panel, theta, Y):
        tmp = state_path + ".tmp.npz"  # .npz suffix: savez won't rename it
        np.savez(tmp, rnd=rnd, panel=panel, theta=theta,
                 Y=Y if Y is not None else np.zeros((0, 0)))
        os.replace(tmp, state_path)

    try:
        panel = orthonormalize(rng.standard_normal((k, b)), None)
        ritz_theta = np.zeros(L)
        ritz_Y: Optional[np.ndarray] = None
        converged = False
        start_rnd = 0
        if state_path and os.path.exists(state_path):
            with np.load(state_path) as st:
                start_rnd = int(st["rnd"]) + 1
                panel = st["panel"]
                ritz_theta = st["theta"]
                ritz_Y = st["Y"] if st["Y"].size else None
            LOG.info("lanczos: resuming from %s at restart %d",
                     state_path, start_rnd)
        for rnd in range(start_rnd, n_restarts):
            panels = [panel]
            Us = []
            # grow the Krylov basis: every appended panel gets one operator
            # application; the residual of B q_j against the basis is the
            # next panel (full reorthogonalization)
            while True:
                basis = np.hstack(panels)
                Uj = apply_op(panels[-1])
                Us.append(Uj)
                if basis.shape[1] + b > kdim:
                    break
                panels.append(orthonormalize(Uj.copy(), basis))
            Q = np.hstack(panels)          # (k, d) — every panel applied
            BU = np.hstack(Us)             # B @ Q, same column order
            G = Q.T @ BU
            G = (G + G.T) / 2
            evals, S = np.linalg.eigh(G)
            order = np.argsort(evals)[::-1][:L]
            theta = np.maximum(evals[order], 0.0)
            Y = Q @ S[:, order]            # Ritz vectors (k, L)
            # residuals of the Ritz pairs under B, from stored BU panels
            BY = BU @ S[:, order]
            resid = np.linalg.norm(BY - Y * theta[None, :], axis=0)
            scale = max(float(theta[0]), 1e-30)
            delta = float(np.abs(np.sqrt(theta) - np.sqrt(ritz_theta)).max()
                          / max(np.sqrt(scale), 1e-30))
            ritz_theta, ritz_Y = theta, Y
            LOG.debug("lanczos restart %d: sigma_max %.6g max-resid %.2e "
                      "delta %.2e (%.0f ms)", rnd, np.sqrt(scale),
                      float(resid.max() / scale), delta, timer.elapsed_ms())
            if resid.max() / scale < tol or delta < tol:
                converged = True
                break
            # thick restart: compress to the Ritz block, pad to b with the
            # strongest residual directions so the next cycle explores new
            # space (Krylov-Schur keeps exactly this invariant subspace)
            carry = Y
            if L < b:
                extra = orthonormalize(
                    BY - Y * theta[None, :]
                    if L > 0 else rng.standard_normal((k, b)), Y)
                carry = np.hstack([Y, extra[:, :b - L]])
            panel = orthonormalize(carry[:, :b], None)
            if state_path:
                save_state(rnd, panel, ritz_theta, ritz_Y)
        if converged and state_path and os.path.exists(state_path):
            os.unlink(state_path)  # state consumed; an unconverged run
            # (restart budget exhausted) keeps it for a longer rerun
        sigma = np.sqrt(ritz_theta)
        return sigma, ritz_Y.astype(np.float32)
    finally:
        if W is not None:
            _panel_ops(mesh, ctx)[1](W)
        if at is not None:
            for arr in (at.ia, at.ja, at.vals):
                flash_free(arr)
