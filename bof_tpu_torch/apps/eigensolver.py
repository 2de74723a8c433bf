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

Both apply U = A^T (A V) either in one streaming pass over A
(`_apply_ata_one_pass`, the default) or as csrcsc + two csrmm passes (the
reference's 'T' dispatch structure, csrmm.cpp:364-420).  On the card the
one-pass operator runs both halves of every ELL band as kernel K2
(`_apply_ata_one_pass_device`, bof_tpu's B9 step): W = A_band V lands in a
device buffer of exactly the band's rows, the band's transpose (built on
the host) multiplies W, and each U partial comes down to a float64 U on the
host.  The host algebra is bof_tpu's, line for line.

With `mesh=` (a `DeviceMesh`, parallel.make_mesh) every operator
application runs row-sharded over the mesh's ranks: by default as two
`csrmm_sharded` passes, or with one_pass=True as the one streaming pass
with both halves sharded (`_apply_ata_one_pass_sharded`).
"""
from __future__ import annotations

import time
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


def _one_pass_stream(a: CsrFlashMatrix, v_np: np.ndarray, ctx, device,
                     fwd_product, t_product, finalize=None) -> np.ndarray:
    """The one-pass device operator's loop (bof_tpu's B9 step with its
    planner), shared by the one-card and the sharded operators: stream
    nnz-budgeted row blocks, band each block's rows by count (count-sorted
    ELL banding), transpose each band on the host (block-local CSC; the
    block is already in DRAM) and band its columns the same way.  Per
    band (an `EllBand`), `fwd_product(v_dev, band)` gives W_sub = A_sub V
    on the card (a row a band row, padding rows past them ignored), and
    per column band `t_product(w, cband)` gives (lo, hi, u) with u the
    float64 host rows of A_sub^T W_sub for the band's columns [lo, hi),
    folded into the float64 U on the host.  `finalize(U)` (the
    identity by default) is the operator's value.  Host prep time goes to
    `eig.prep_s`, the wait for A's blocks to `eig.disk_wait_s`."""
    import scipy.sparse as sps

    from ..sparse import spmm_device as sdev
    from ..sparse.csr import fill_row_blocks, stream_row_blocks

    cfg = ctx.config
    k = a.shape[1]
    ia_np = a.read_ia()
    blocks = fill_row_blocks(ia_np, cfg.max_nnzs)
    v_dev = dev.to_device(np.ascontiguousarray(v_np, np.float32), device)
    b = v_dev.shape[1]
    entry_cap = max(1 << 14, int(cfg.hbm_budget // 6 // (b * 4)))
    sort_rows = getattr(cfg, "ell_sort_rows", True)
    narrow = getattr(cfg, "ell_idx_narrow", True)
    fwd_idt = sdev.ell_idx_dtype(k, narrow)  # forward panel height = k
    U = np.zeros((k, b), np.float64)
    t_wait = time.perf_counter()
    for r, e, ja_blk, va_blk in stream_row_blocks(a, ia_np, blocks, ctx):
        METRICS.add("eig.disk_wait_s", time.perf_counter() - t_wait)
        blk_ia = ia_np[r:e + 1] - int(ia_np[r])
        counts = np.diff(blk_ia)
        # forward rows band by nnz; the transposed build selects the
        # same rows so its indices line up with W's row order
        order, ranges = sdev.band_plan(counts, entry_cap, sort_rows)
        blk_sp = sps.csr_matrix(
            (va_blk, ja_blk.astype(np.int64), blk_ia.astype(np.int64)),
            shape=(e - r, k))
        t0 = time.perf_counter()
        for s0, s1 in ranges:
            rows_sel = order[s0:s1]
            band = sdev.build_band(blk_ia, ja_blk, va_blk, rows_sel, counts,
                                   fwd_idt)
            METRICS.add("eig.prep_s", time.perf_counter() - t0)
            w = fwd_product(v_dev, band)
            # transpose the selected rows in DRAM; the CSC's row indices
            # are positions within rows_sel, exactly W's rows (W has a
            # row for each, so every index is below its height).  Its
            # columns always band sorted
            t0 = time.perf_counter()
            sub = blk_sp[rows_sel].tocsc()
            ccounts = np.diff(sub.indptr)
            csort, cranges = sdev.band_plan(ccounts, entry_cap)
            t_idt = sdev.ell_idx_dtype(len(rows_sel), narrow)
            for c0, c1 in cranges:
                cband = sdev.build_band(sub.indptr.astype(np.int64),
                                        sub.indices, sub.data, csort[c0:c1],
                                        ccounts, t_idt)
                METRICS.add("eig.prep_s", time.perf_counter() - t0)
                lo, hi, u_np = t_product(w, cband)
                U[cband.rows[lo:hi]] += u_np
                t0 = time.perf_counter()
        t_wait = time.perf_counter()
    METRICS.add("eig.op_applies")
    return U if finalize is None else finalize(U)


def _upload(band, device, lo, hi):
    """Rows [lo, hi) of a band on `device`; the host folds the results."""
    from ..sparse import spmm_device as sdev
    t0 = time.perf_counter()
    up = sdev.upload_band(band, device, lo, hi, with_rows=False)
    METRICS.add("eig.h2d_s", time.perf_counter() - t0)
    METRICS.add("eig.h2d_bytes", up.nbytes)
    return up


def _ell_product(panel, band, device, impl):
    """One ELL product (K2) of exactly a band's rows on `device`."""
    from ..sparse import spmm_device as sdev
    up = _upload(band, device, 0, len(band.counts))
    return sdev.spmm_ell_block_dispatch(panel, up.ja, up.va, impl,
                                        counts=up.counts)


def _download_u(u_part) -> np.ndarray:
    t0 = time.perf_counter()
    u_np = dev.from_device(u_part)  # waits for the band's K2s
    METRICS.add("eig.d2h_s", time.perf_counter() - t0)
    METRICS.add("eig.d2h_bytes", u_np.nbytes)
    return u_np


def _apply_ata_one_pass_device(a: CsrFlashMatrix, v_np: np.ndarray,
                               ctx) -> np.ndarray:
    """Device variant of the one-pass operator on one card: per band,
    W_sub = A_sub V and U_part = A_sub^T W_sub are both K2 launches on
    exactly the band's rows (each row's real slot count passed, so padding
    is never read); W_sub stays on the card, and each U partial is
    downloaded and folded into the float64 U on the host."""
    device = dev.resolve_device(ctx.config.device)
    impl = getattr(ctx.config, "sparse_device_impl", "auto")

    def fwd(v_dev, band):
        return _ell_product(v_dev, band, device, impl)

    def trans(w, cband):
        u = _download_u(_ell_product(w, cband, device, impl))
        return 0, len(u), u

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
    the band's columns the same way against that W, and each rank folds
    its columns' float64 partials into its own U.  Every row of every
    partial is computed by exactly one rank, so one float64 all-reduce at
    the end sums the ranks' U into the operator's value, and A's bytes
    still cross the disk once per rank and application.  fp64 values
    raise (the kernels are fp32)."""
    from ..parallel import mesh as pmesh
    from ..parallel.csrmm_sp import sharded_spmm_step

    if not dev.dtype_native_on_device(a.vals.dtype):
        raise ValueError(
            f"sharded one_pass cannot represent {a.vals.dtype} on the "
            "card; use one_pass without a mesh (exact host path)")
    device = pmesh.mesh_device(mesh)
    step = sharded_spmm_step(mesh)
    replicate = _replicate_step(mesh)

    def own(band):
        """This rank's run [lo, hi) of the band's rows, on the card."""
        lo, hi, run = pmesh.row_run(mesh, len(band.counts))
        return lo, hi, run, _upload(band, device, lo, hi)

    def fwd(v_dev, band):
        lo, hi, run, up = own(band)
        w_loc = torch.zeros((run, v_dev.shape[1]), dtype=torch.float32,
                            device=device)
        if hi > lo:
            w_loc[:hi - lo] = step(v_dev, up.ja, up.va, up.counts)
        return replicate(w_loc)  # the band's W, whole on every rank

    def trans(w, cband):
        lo, hi, _, up = own(cband)
        if hi <= lo:
            return lo, lo, np.zeros((0, w.shape[1]), np.float64)
        return lo, hi, _download_u(step(w, up.ja, up.va, up.counts))

    def finalize(U):
        u_dev = dev.to_device(U, device)
        pmesh.all_reduce(u_dev)
        return dev.from_device(u_dev)

    return _one_pass_stream(a, v_np, ctx, device, fwd, trans, finalize)


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

    at = W = None
    if one_pass is None or one_pass:
        def half_step(v_np):
            return _apply_ata_one_pass(a, v_np, ctx)
    else:
        at = csrcsc_scratch(a, ctx=ctx)  # A^T, materialized once
        W = flash_empty((m, L), np.float32, ctx=ctx)
        V = mem_array((k, L), np.float32, ctx=ctx)
        U = mem_array((k, L), np.float32, ctx=ctx)

        def half_step(v_np):
            """U = (A^T A) V via two flash csrmm passes."""
            V.write_all(v_np.astype(np.float32))
            csrmm(a, V, W, ctx=ctx)
            csrmm(at, W, U, ctx=ctx)
            METRICS.add("eig.op_applies")
            return U.read_all().astype(np.float64)

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
    if one_pass and mesh is not None:
        def apply_op(v_np: np.ndarray) -> np.ndarray:
            return _apply_ata_one_pass_sharded(a, v_np, mesh, ctx)
    elif one_pass:
        def apply_op(v_np: np.ndarray) -> np.ndarray:
            """B v = A^T (A v) in one streaming pass over A."""
            return _apply_ata_one_pass(a, v_np, ctx)
    else:
        at = csrcsc_scratch(a, ctx=ctx)  # A^T, materialized once
        if mesh is not None:
            from ..parallel import csrmm_sharded
            from ..parallel.mesh import shared_empty, shared_free

            def _empty(shape):
                return shared_empty(shape, np.float32, mesh, ctx)

            def _free(arr):
                shared_free(arr, mesh)

            def _spmm(mat, x, out):
                csrmm_sharded(mat, x, out, mesh=mesh, ctx=ctx)
        else:
            def _empty(shape):
                return flash_empty(shape, np.float32, ctx=ctx)

            def _free(arr):
                flash_free(arr)

            def _spmm(mat, x, out):
                csrmm(mat, x, out, ctx=ctx)
        W = _empty((m, b))

        def apply_op(v_np: np.ndarray) -> np.ndarray:
            """B v = A^T (A v), (k, w) -> (k, w) float64, w <= b."""
            w = v_np.shape[1]
            Vp = mem_array((k, w), np.float32,
                           data=v_np.astype(np.float32), ctx=ctx)
            Wp = W if w == b else _empty((m, w))
            # U is read whole after every rank wrote its rows: a shared
            # panel under a mesh, host memory on one card
            Up = (_empty((k, w)) if mesh is not None
                  else mem_array((k, w), np.float32, ctx=ctx))
            try:
                _spmm(a, Vp, Wp)
                _spmm(at, Wp, Up)
                u = Up.read_all().astype(np.float64)
            finally:
                if Wp is not W:
                    _free(Wp)
                if mesh is not None:
                    _free(Up)
            METRICS.add("eig.op_applies")
            return u

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
            _free(W)
        if at is not None:
            for arr in (at.ia, at.ja, at.vals):
                flash_free(arr)
