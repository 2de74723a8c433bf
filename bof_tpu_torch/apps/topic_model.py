"""Out-of-core topic modeling over a flash-resident doc-term matrix.

The port of `bof_tpu/apps/topic_model.py` (the NSDI'19 paper's Table 5
workload, ISLE topic modeling on bag-of-words matrices), the same
composition in its spectral form:

  1. project:  P = A R          (csrmm, kernel K2 on the card; R a dense
                                 random or spectral basis, P (docs x dim))
  2. cluster:  k-means on P     (kmeans_fit / lloyds_iter, kernel pair B7)
  3. lift:     T = A^T Y / n_c  (host: the rows of A summed by label,
                                 bof_tpu's arithmetic unchanged)

Every heavy pass streams the CSR matrix; only (topics x vocab) and
(docs x dim) panels are materialized (the latter on flash scratch).
With `mesh=` (a `DeviceMesh`, parallel.make_mesh) the projection runs
as `csrmm_sharded` and the Lloyd steps data-parallel over the mesh's
ranks (`kmeans_fit_sharded`, or `lloyds_iter_ooc_sharded` after a
sampled fit); the P and label panels are then scratch files every rank
sees, and every rank returns the same result.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from ..context import get_context
from ..core.flash_array import flash_empty, flash_free, mem_array
from ..ops.kmeans import kmeans_fit
from ..sparse import CsrFlashMatrix, csrmm
from ..utils import LOG, METRICS, Timer


def topic_model(a: CsrFlashMatrix, n_topics: int, proj_dim: int = 64,
                n_iters: int = 8, seed: int = 0, sample_rate: float = 1.0,
                state_path: Optional[str] = None,
                mesh=None, ctx=None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (topic_word (n_topics, vocab) row-normalized,
    doc_labels (docs,) int32).  sample_rate < 1 clusters on a uniform doc
    sample and assigns the full corpus in one streaming pass — the
    paper's ISLE runs use sample rate 0.1 (Table 5).  `state_path`
    checkpoints the clustering stage (kmeans_fit's state, bof_tpu's
    format).  With `mesh`, the projection runs row-sharded and the Lloyd
    steps data-parallel over the mesh (parallel/)."""
    ctx = ctx or a.ctx or get_context()
    docs, vocab = a.shape
    rng = np.random.default_rng(seed)

    # 1. random projection basis (Johnson-Lindenstrauss); spectral users
    #    can pass the eigensolver's V via topic_model_with_basis
    r_np = (rng.standard_normal((vocab, proj_dim))
            / np.sqrt(proj_dim)).astype(np.float32)
    return topic_model_with_basis(a, r_np, n_topics, n_iters=n_iters,
                                  seed=seed, sample_rate=sample_rate,
                                  state_path=state_path, mesh=mesh,
                                  ctx=ctx)


def topic_model_with_basis(a: CsrFlashMatrix, basis: np.ndarray,
                           n_topics: int, n_iters: int = 8, seed: int = 0,
                           sample_rate: float = 1.0,
                           state_path: Optional[str] = None, mesh=None,
                           ctx=None) -> Tuple[np.ndarray, np.ndarray]:
    """`topic_model` on a given (vocab, dim) projection basis.  Stage
    seconds go to METRICS as `topic.{project,cluster,assign,lift}_s`."""
    ctx = ctx or a.ctx or get_context()
    docs, vocab = a.shape
    proj_dim = basis.shape[1]
    timer = Timer()

    R = mem_array((vocab, proj_dim), np.float32, data=basis, ctx=ctx)
    if mesh is None:
        P = flash_empty((docs, proj_dim), np.float32, ctx=ctx)
        labels = flash_empty((docs,), np.int32, ctx=ctx)
    else:
        from ..parallel import (csrmm_sharded, kmeans_fit_sharded,
                                lloyds_iter_ooc_sharded)
        from ..parallel.mesh import shared_empty, shared_free
        P = shared_empty((docs, proj_dim), np.float32, mesh, ctx)
        labels = shared_empty((docs,), np.int32, mesh, ctx)
    try:
        t0 = time.perf_counter()
        if mesh is not None:                         # project docs
            csrmm_sharded(a, R, P, mesh=mesh, ctx=ctx)
        else:
            csrmm(a, R, P, ctx=ctx)
        METRICS.add("topic.project_s", time.perf_counter() - t0)
        LOG.debug("topic_model: projected in %.0f ms", timer.elapsed_ms())
        t0 = time.perf_counter()
        if sample_rate < 1.0:
            # ISLE-style: fit centers on a doc sample (n_iters streaming
            # passes touch only the sample), then one full assignment pass
            from ..ops.kmeans import (_sample_indices, gather_rows,
                                      lloyds_iter)
            rng = np.random.default_rng(seed)
            s = max(n_topics * 8, int(docs * sample_rate))
            idx = _sample_indices(docs, min(s, docs), rng)
            samp = gather_rows(P, idx)
            Ps = mem_array((len(idx), proj_dim), np.float32, data=samp,
                           ctx=ctx)
            centers, _ = kmeans_fit(Ps, n_topics, n_iters=n_iters,
                                    seed=seed, n_init=3,
                                    state_path=state_path, ctx=ctx)
            t1 = time.perf_counter()
            METRICS.add("topic.cluster_s", t1 - t0)
            if mesh is not None:
                _, inertia, _ = lloyds_iter_ooc_sharded(
                    P, centers, labels_out=labels, mesh=mesh, ctx=ctx)
            else:
                _, inertia, _ = lloyds_iter(P, centers, labels_out=labels,
                                            ctx=ctx)
            METRICS.add("topic.assign_s", time.perf_counter() - t1)
        elif mesh is not None:
            _, inertia = kmeans_fit_sharded(P, n_topics, n_iters=n_iters,
                                            seed=seed, labels_out=labels,
                                            mesh=mesh, ctx=ctx)
            METRICS.add("topic.cluster_s", time.perf_counter() - t0)
        else:
            _, inertia = kmeans_fit(P, n_topics, n_iters=n_iters,
                                    seed=seed, n_init=3,
                                    labels_out=labels,
                                    state_path=state_path, ctx=ctx)
            METRICS.add("topic.cluster_s", time.perf_counter() - t0)
        lab_np = labels.read_all()

        # 3. lift: topic-word T = A^T one_hot(labels), normalized — the
        # (docs x n_topics) one-hot is never materialized: T[t] is the sum
        # of the CSR rows labeled t, streamed per nnz-budgeted row block
        t0 = time.perf_counter()
        tw = lift_topics(a, lab_np, n_topics, ctx=ctx)  # (topics, vocab)
        norm = tw.sum(axis=1, keepdims=True)
        tw = np.where(norm > 0, tw / np.maximum(norm, 1e-30), 0.0)
        METRICS.add("topic.lift_s", time.perf_counter() - t0)
        LOG.debug("topic_model: %d topics over %dx%d nnz=%d in %.0f ms "
                  "(inertia %.4g)", n_topics, docs, vocab, a.nnz,
                  timer.elapsed_ms(), inertia)
        return tw.astype(np.float32), lab_np
    finally:
        if mesh is None:
            flash_free(P)
            flash_free(labels)
        else:
            shared_free(P, mesh)
            shared_free(labels, mesh)


def lift_topics(a: CsrFlashMatrix, labels_np: np.ndarray, n_topics: int,
                ctx=None) -> np.ndarray:
    """Streamed topic lift: T[t, w] = sum of A[d, w] over docs d with
    label t — algebraically one_hot(labels)^T A, computed WITHOUT
    materializing the one-hot (reference semantics: the csrmm 'T' pass the
    paper's ISLE uses to form cluster centroids in vocab space, Table 5).

    Streams nnz-budgeted CSR row blocks (the reference's fill_blocks
    discipline, blas_utils.h:84-97) and label-aggregates each block on the
    host: a fused bincount over (topic * vocab + col) when T is small
    enough for the scratch histogram, an indexed scatter-add otherwise.
    Peak host memory is O(row block + T).  Returns (n_topics, vocab)
    float32, unnormalized.  bof_tpu's host code, unchanged."""
    from ..sparse.csr import fill_row_blocks

    ctx = ctx or a.ctx or get_context()
    docs, vocab = a.shape
    if labels_np.shape != (docs,):
        raise ValueError(f"labels shape {labels_np.shape} != ({docs},)")
    ia = a.read_ia()
    blocks = fill_row_blocks(ia, ctx.config.max_nnzs)
    # accumulate in ONE float64 buffer (bincount's native dtype): adding
    # per-block float64 histograms into a float32 T would allocate two
    # T-sized temporaries per block; cast once at return instead
    T = np.zeros((n_topics, vocab), np.float64)
    # bincount allocates a histogram of T.size per block — use it only
    # while that scratch stays modest; otherwise np.add.at (no scratch,
    # slower per nnz)
    use_bincount = n_topics * vocab <= (1 << 26)
    for r0, r1 in blocks:
        nz0, nz1 = int(ia[r0]), int(ia[r1])
        if nz1 == nz0:
            continue
        ja_blk = a.ja.read_block(nz0, nz1 - nz0)
        va_blk = a.vals.read_block(nz0, nz1 - nz0)
        t_idx = np.repeat(labels_np[r0:r1].astype(np.int64),
                          np.diff(ia[r0:r1 + 1]).astype(np.int64))
        if use_bincount:
            flat = t_idx * vocab + ja_blk.astype(np.int64)
            T += np.bincount(flat, weights=va_blk,
                             minlength=n_topics * vocab
                             ).reshape(n_topics, vocab)
        else:
            np.add.at(T, (t_idx, ja_blk), va_blk)
    return T.astype(np.float32)
