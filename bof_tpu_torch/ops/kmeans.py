"""Out-of-core k-means: a fused Lloyd block step and Lloyd's iteration.

The port of `bof_tpu/ops/kmeans.py` (reference: src/blas/kmeans.cpp:27-198,
include/tasks/kmeans_task.h:53-82, drivers/kmeans.cpp:103-189).  The
reference writes the (points x centers) distance matrix to disk and
argmins it in a second pass; bof_tpu fuses the whole Lloyd step on the
device.  Here that step is the CUDA kernel pair B7 (`csrc/kmeans.cu`):
`lloyd_assign` computes each point's partial distance |c|^2 - 2 p.c to
every center and keeps only the running min and argmin, so the (bn x k)
distance block never reaches device memory, and `lloyd_accumulate` adds
each center's points to its sum and count.  A full iteration makes one
pass over the points.  (|p|^2 is constant per point and left out of the
argmin; it is added only to report inertia.)

B7 computes in fp32-class arithmetic at every `matmul_precision`
(`lloyd_assign` in 3xTF32 on the tensor cores, the sums in fp32), at
least as precise as each of bof_tpu's tiers.  float64 points take
bof_tpu's exact numpy host step (its FP_DOUBLE_PRECISION semantics, not a
fall-back).  The kernel wrappers launch on CUDA tensors and run their
plain versions (`lloyd_assign_ref`, `lloyd_accumulate_ref`) on CPU
tensors only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..context import get_context
from ..core.flash_array import FlashArray
from ..core.pipeline import PrefetchSeq, TicketWindow
from ..utils import LOG, METRICS, Timer
from . import device as dev
from .cuda_lib import build
from .matmul_cuda import fp32_workspace, k1_packs, tf32_ldw, tf32_truncate


def _check_block(p: torch.Tensor, k: int, *tensors) -> None:
    if p.dim() != 2 or p.dtype != torch.float32 or not p.is_contiguous():
        raise ValueError("B7 takes points as a contiguous fp32 (bn, d) "
                         f"tensor, got {p.dtype} {tuple(p.shape)}")
    if p.shape[1] < 1 or k < 1:
        raise ValueError(f"B7 needs d >= 1 and k >= 1 (d {p.shape[1]}, "
                         f"k {k})")
    devs = {p.device} | {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"B7 operands on several devices: {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("B7 needs contiguous tensors")


def lloyd_assign_ref(p: torch.Tensor, centers: torch.Tensor,
                     c_norms: torch.Tensor):
    """Plain version of `lloyd_assign`: the (bn, k) partial distances by
    addmm, then min(dim=1) (the first index on a tie).  Returns (labels
    int32, mind fp32)."""
    pd = torch.addmm(c_norms[None, :], p, centers.T, alpha=-2.0)
    mind, labels = torch.min(pd, dim=1)
    return labels.to(torch.int32), mind


def lloyd_assign_tf32x3_ref(p: torch.Tensor, centers: torch.Tensor,
                            c_norms: torch.Tensor):
    """Plain 3xTF32 emulation of `lloyd_assign`'s arithmetic: each operand
    split as hi = tf32_truncate(x) and lo = tf32_truncate(x - hi) (the
    kernel's lo, truncated again by the tensor cores), G = lo_p hi_c^T +
    hi_p lo_c^T + hi_p hi_c^T with exact products, a = G - c_norms/2
    summed in float64 and rounded once to fp32 (the kernel sums in fp32,
    from -c_norms/2, in its own order), then the partial distance -2a
    (exact) and min(dim=1) as in `lloyd_assign_ref`.  For tests and
    chip_smoke.py only.  Returns (labels int32, mind fp32)."""
    def split(x):
        hi = tf32_truncate(x)
        return hi.double(), tf32_truncate(x - hi).double()
    p_hi, p_lo = split(p)
    c_hi, c_lo = split(centers)
    a = (p_lo @ c_hi.T + p_hi @ c_lo.T + p_hi @ c_hi.T
         - 0.5 * c_norms.double()[None, :]).to(torch.float32)
    mind, labels = torch.min(-2.0 * a, dim=1)
    return labels.to(torch.int32), mind


def lloyd_workspace(bn: int, k: int, d: int, *, aligned: tuple) -> dict:
    """Row counts of the fp32 workspaces `lloyd_assign`'s split pass writes,
    each rows x `tf32_ldw(d)`: 'p_lo' and 'c_lo' (x - tf32(x)) always, and
    'p_x'/'c_x' (K-major copies) where TMA cannot read the points or the
    centers where they lie: d not a multiple of 4 floats, or a base that
    is not 16-byte `aligned` (for P and C)."""
    # P (bn, d) and C (k, d) lie K-major, as K1's A (M, K) and B (N, K)
    packs = k1_packs(False, True, d, d, torch.float32, aligned)
    rows = {}
    for name, n, pack in zip("pc", (bn, k), packs):
        if pack:
            rows[f"{name}_x"] = n
        rows[f"{name}_lo"] = n
    return rows


def lloyd_accumulate_ref(p: torch.Tensor, labels: torch.Tensor,
                         sums: torch.Tensor, counts: torch.Tensor) -> None:
    """Plain version of `lloyd_accumulate`: index_add_ of the points and
    of ones into sums (fp32) and counts (int32), in place."""
    idx = labels.long()
    sums.index_add_(0, idx, p)
    counts.index_add_(0, idx, torch.ones_like(labels))


def lloyd_accumulate_ordered_ref(p: torch.Tensor, labels: torch.Tensor,
                                 sums: torch.Tensor, counts: torch.Tensor,
                                 budget: int = 1 << 28) -> None:
    """Plain version of `lloyd_accumulate` in the kernel's order of
    additions, so bit for bit: each center's rows in index order, gathered
    into a zero-padded (centers, max count, d) block, added one row at a
    time into an fp32 sum from 0 (adds only, so nothing contracts to an
    fma), then sums += that sum for every center and counts += the exact
    counts.  Centers go in batches whose block stays under `budget` bytes.
    For tests and chip_smoke.py."""
    k, d = sums.shape
    cnt = torch.bincount(labels.long(), minlength=k)
    order = torch.sort(labels.long(), stable=True).indices
    cnt_h = cnt.tolist()
    starts = (torch.cumsum(cnt, 0) - cnt).tolist()
    acc_all = torch.zeros_like(sums)
    j0 = 0
    while j0 < k:
        j1, width = j0 + 1, cnt_h[j0]
        while j1 < k and (j1 + 1 - j0) * max(width, cnt_h[j1]) * d * 4 \
                <= budget:
            width = max(width, cnt_h[j1])
            j1 += 1
        rows = p.new_zeros((j1 - j0, width, d))
        for j in range(j0, j1):
            rows[j - j0, :cnt_h[j]] = p[order[starts[j]:starts[j] + cnt_h[j]]]
        acc = torch.zeros_like(acc_all[j0:j1])
        for t in range(width):
            acc = acc + rows[:, t]
        acc_all[j0:j1] = acc
        j0 = j1
    sums.add_(acc_all)
    counts.add_(cnt.to(counts.dtype))


def lloyd_block_ref(p, centers, c_norms, sums, counts):
    """Plain version of B7 (`lloyd_block`)."""
    labels, mind = lloyd_assign_ref(p, centers, c_norms)
    lloyd_accumulate_ref(p, labels, sums, counts)
    return labels, mind


def lloyd_assign(p: torch.Tensor, centers: torch.Tensor,
                 c_norms: torch.Tensor):
    """Kernel 1 of B7: labels[i] = argmin_j (c_norms[j] - 2 p[i].centers[j])
    (the first index on a tie) and mind[i] = that minimum, for p (bn, d),
    centers (k, d) and c_norms (k,), all fp32 and contiguous.  Returns
    (labels int32 (bn,), mind fp32 (bn,)).  CUDA tensors launch the
    kernel (3xTF32 on the tensor cores, `lloyd_assign_tf32x3_ref`'s
    arithmetic up to summation order) on the current stream, with the
    split pass's workspace (`lloyd_workspace`); CPU tensors take
    `lloyd_assign_ref`."""
    k = centers.shape[0]
    _check_block(p, k, centers, c_norms)
    if (centers.dtype != torch.float32 or c_norms.dtype != torch.float32
            or tuple(centers.shape) != (k, p.shape[1])
            or tuple(c_norms.shape) != (k,)):
        raise ValueError("lloyd_assign: centers (k, d) and c_norms (k,) "
                         "must be fp32 and match the points")
    if p.device.type == "cpu":
        return lloyd_assign_ref(p, centers, c_norms)
    if p.device.type != "cuda":
        raise ValueError(f"lloyd_assign: unsupported device {p.device}")
    bn, d = p.shape
    labels = torch.empty(bn, dtype=torch.int32, device=p.device)
    mind = torch.empty(bn, dtype=torch.float32, device=p.device)
    rows = lloyd_workspace(bn, k, d, aligned=(p.data_ptr() % 16 == 0,
                                              centers.data_ptr() % 16 == 0))
    ldw = tf32_ldw(d)
    ws, ptr = fp32_workspace(rows, ldw, p.device)
    lib = build()
    with torch.cuda.device(p.device):
        rc = lib.bof_lloyd_assign(
            p.data_ptr(), centers.data_ptr(), c_norms.data_ptr(),
            labels.data_ptr(), mind.data_ptr(), ptr.get("p_x"), ptr["p_lo"],
            ptr.get("c_x"), ptr["c_lo"], ldw, bn, k, d,
            torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bof_lloyd_assign launch failed: CUDA error {rc}")
    lloyd_assign.launches += 1
    return labels, mind


def lloyd_accumulate(p: torch.Tensor, labels: torch.Tensor,
                     sums: torch.Tensor, counts: torch.Tensor) -> None:
    """Kernel 2 of B7: sums[j] += the points labelled j and counts[j] +=
    their number, in place; p (bn, d) fp32, labels (bn,) int32 in [0, k),
    sums (k, d) fp32, counts (k,) int32 (exact).  Deterministic on the
    card: a counting sort of the labels, then each center adds its points
    in index order (`lloyd_accumulate_ordered_ref`'s bits), in int32
    scratch sized by the library's
    `bof_lloyd_accumulate_scratch_ints`.  CPU tensors take
    `lloyd_accumulate_ref`."""
    k = sums.shape[0]
    _check_block(p, k, labels, sums, counts)
    if (labels.dtype != torch.int32 or tuple(labels.shape) != (p.shape[0],)
            or sums.dtype != torch.float32
            or tuple(sums.shape) != (k, p.shape[1])
            or counts.dtype != torch.int32 or tuple(counts.shape) != (k,)):
        raise ValueError("lloyd_accumulate: labels (bn,) int32, sums (k, d) "
                         "fp32 and counts (k,) int32 must match the points")
    if p.device.type == "cpu":
        lloyd_accumulate_ref(p, labels, sums, counts)
        return
    if p.device.type != "cuda":
        raise ValueError(f"lloyd_accumulate: unsupported device {p.device}")
    bn, d = p.shape
    lib = build()
    n_scratch = lib.bof_lloyd_accumulate_scratch_ints(bn, k)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        rc = lib.bof_lloyd_accumulate(
            p.data_ptr(), labels.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), scratch.data_ptr(), n_scratch, bn, k, d,
            torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bof_lloyd_accumulate launch failed: CUDA error "
                           f"{rc}")
    lloyd_accumulate.launches += 1


def lloyd_block(p, centers, c_norms, sums, counts):
    """B7, bof_tpu's `lloyd_block` step on one point block: assign, then
    accumulate into sums and counts in place.  Returns (labels, mind)."""
    labels, mind = lloyd_assign(p, centers, c_norms)
    lloyd_accumulate(p, labels, sums, counts)
    return labels, mind


def reset_launch_counts() -> None:
    """Set both B7 kernels' launch counts to 0."""
    lloyd_assign.launches = 0
    lloyd_accumulate.launches = 0


reset_launch_counts()


class _DeviceStep:
    """The fp32 device state of one Lloyd pass: the centers, their norms,
    the running sums and counts and the sum of the blocks' minima."""

    def __init__(self, centers: np.ndarray, device: torch.device):
        k, d = centers.shape
        self.centers = np.ascontiguousarray(centers, dtype=np.float32)
        self.c_dev = dev.to_device(self.centers, device)
        self.c_norms = (self.c_dev * self.c_dev).sum(1)
        self.sums = torch.zeros((k, d), dtype=torch.float32, device=device)
        self.counts = torch.zeros(k, dtype=torch.int32, device=device)
        self.mind_sum = torch.zeros((), dtype=torch.float64, device=device)

    def block(self, p_blk: torch.Tensor) -> torch.Tensor:
        labels, mind = lloyd_block(p_blk, self.c_dev, self.c_norms,
                                   self.sums, self.counts)
        self.mind_sum += mind.to(torch.float64).sum()
        return labels

    def finish(self, p_norm2: float):
        """(new centers, inertia, counts as float32, as bof_tpu returns
        them); an empty cluster keeps its center."""
        counts = dev.from_device(self.counts).astype(np.float32)
        sums = dev.from_device(self.sums)
        inertia = float(self.mind_sum) + p_norm2
        safe = np.maximum(counts, 1.0)[:, None]
        new = np.where(counts[:, None] > 0, sums / safe, self.centers)
        return new.astype(np.float32), inertia, counts


def _write_labels(labels_out: FlashArray, r0: int, lab_np: np.ndarray,
                  tickets: TicketWindow) -> None:
    off, sinfo = labels_out.block_access(r0, len(lab_np))
    labels_out._invalidate(off, sinfo)
    tickets.push(labels_out.store.write(off, sinfo,
                                        lab_np.view(np.uint8).ravel()))


def lloyds_iter(points: FlashArray, centers: np.ndarray,
                labels_out: Optional[FlashArray] = None,
                blk_rows: Optional[int] = None, ctx=None
                ) -> Tuple[np.ndarray, float, np.ndarray]:
    """One Lloyd iteration: returns (new_centers, inertia, counts).

    points: flash (n, d) row-major; centers: host (k, d) (the reference
    also keeps centers in DRAM, drivers/kmeans.cpp).  If labels_out is
    given, per-point assignments are written to it (int32)."""
    ctx = ctx or points.ctx or get_context()
    cfg = ctx.config
    n, d = points.shape
    k, d2 = centers.shape
    if d != d2:
        raise ValueError("dim mismatch")
    if points.order != "R":
        raise ValueError("points must be row-major (one point per row)")
    blk = blk_rows or _lloyd_blk_rows(n, d, k, cfg.hbm_budget,
                                      itemsize=points.dtype.itemsize)
    # fp64 always takes the exact host step (B7 computes in fp32)
    host_mode = (points.dtype == np.float64
                 or not dev.dtype_native_on_device(points.dtype))
    if host_mode:
        # BLAS dgemm for the cross term, sparse-matmul center accumulation
        # (the reference's FP_DOUBLE_PRECISION build runs MKL double on
        # the host, kmeans_task.h:53-82 + bof_types.h:24-42)
        import scipy.sparse as sps
        centers = np.ascontiguousarray(centers, dtype=np.float64)
        c_norms_h = np.einsum("ij,ij->i", centers, centers)
        sums_h = np.zeros((k, d), np.float64)
        counts_h = np.zeros((k,), np.float64)
        inertia = 0.0
    else:
        device = dev.resolve_device(cfg.device)
        step = _DeviceStep(centers, device)

    cache = ctx.pin_cache()
    accesses, spans = [], []
    for r0 in range(0, n, blk):
        bn = min(blk, n - r0)
        accesses.append((points.store,) + points.block_access(r0, bn, 0, d))
        spans.append((r0, bn))
    pf = PrefetchSeq(cache, accesses, depth=cfg.pipeline_depth)

    p_norm2 = 0.0
    write_tickets = TicketWindow(depth=8)
    try:
        for bi, (r0, bn) in enumerate(spans):
            with METRICS.span("kmeans.disk_wait"):
                p_host = pf.get(bi).view(points.dtype).reshape(bn, d)
            # einsum accumulates in f64 without materializing a full f64
            # copy + squared temporary of the block
            blk_norm2 = float(np.einsum("ij,ij->", p_host, p_host,
                                        dtype=np.float64))
            if host_mode:
                g = p_host @ centers.T  # dgemm
                pd = c_norms_h[None, :] - 2.0 * g
                lab_np = pd.argmin(axis=1).astype(np.int32)
                # bof_tpu's order of additions: the same float64 bits
                inertia += float(pd.min(axis=1).sum()) + blk_norm2
                counts_h += np.bincount(lab_np, minlength=k)
                onehot = sps.csr_matrix(
                    (np.ones(bn, np.float64), lab_np,
                     np.arange(bn + 1, dtype=np.int64)), shape=(bn, k))
                sums_h += onehot.T @ p_host
            else:
                p_norm2 += blk_norm2
                with METRICS.span("kmeans.h2d") as sp:
                    p_blk = dev.to_device(
                        p_host.astype(np.float32, copy=False), device)
                    sp.nbytes = p_blk.nbytes
                labels = step.block(p_blk)
            pf.done(bi)
            if labels_out is not None:
                if not host_mode:
                    with METRICS.span("kmeans.d2h"):
                        lab_np = dev.from_device(labels)
                _write_labels(labels_out, r0, lab_np, write_tickets)
    finally:
        pf.close()  # an exception mid-stream must not leak pinned tiles
    write_tickets.wait_all()
    if labels_out is not None:
        labels_out.store.flush()

    if not host_mode:
        new_centers, inertia, counts_np = step.finish(p_norm2)
        return new_centers.astype(points.dtype), inertia, counts_np
    # empty clusters keep their old center (standard Lloyd fallback; the
    # reference divides unconditionally, drivers/kmeans.cpp:132-156)
    safe = np.maximum(counts_h, 1.0)[:, None]
    new_centers = np.where(counts_h[:, None] > 0, sums_h / safe, centers)
    return new_centers.astype(points.dtype), inertia, counts_h


def _lloyd_blk_rows(n: int, d: int, k: int, hbm_budget: int,
                    itemsize: int = 4) -> int:
    """Power-of-two row block shared by the streaming and device-resident
    Lloyd paths (bof_tpu's sizing, so both packages make the same blocks):
    bounded by the 64 MB host tile and by the budget over the (blk, k)
    term.  `itemsize` is the POINT dtype's (8 for the fp64 host path)."""
    cap = max(1024, min((64 << 20) // max(itemsize * d, 1),
                        int(hbm_budget // 8 // max(4 * k, 1))))
    return max(1, min(1 << (cap.bit_length() - 1), n))


def _device_points(points: FlashArray, ctx):
    """Upload the whole point panel to the device once (kmeans_fit does
    when it fits the device budget: a multi-iteration fit then crosses the
    link once instead of once a pass).  Returns (p_dev (n, d) float32,
    sum |p|^2 as float64).  Host peak is the one float32 panel; the norm
    accumulates per chunk.  A failed upload raises."""
    n, d = points.shape
    device = dev.resolve_device(ctx.config.device)
    host = points.read_block(0, n, 0, d).astype(np.float32, copy=False)
    p_norm2 = 0.0
    step = max(1, (64 << 20) // max(4 * d, 1))
    for r0 in range(0, n, step):
        ch = host[r0:r0 + step]
        p_norm2 += float(np.einsum("ij,ij->", ch, ch, dtype=np.float64))
    p_dev = dev.to_device(host, device)
    dev.sync(p_dev)
    METRICS.add("kmeans.h2d_bytes", p_dev.nbytes)
    return p_dev, p_norm2


def _lloyds_iter_device(p_dev: torch.Tensor, p_norm2: float,
                        centers: np.ndarray,
                        labels_out: Optional[FlashArray] = None,
                        ctx=None) -> Tuple[np.ndarray, float, np.ndarray]:
    """One Lloyd iteration over device-resident points: the same block
    step as lloyds_iter, on row slices of the resident panel."""
    ctx = ctx or get_context()
    n, d = p_dev.shape
    k = centers.shape[0]
    # the streaming path's block size, so both make the same blocks
    chunk = _lloyd_blk_rows(n, d, k, ctx.config.hbm_budget)
    step = _DeviceStep(centers, p_dev.device)
    write_tickets = TicketWindow(depth=8)
    for r0 in range(0, n, chunk):
        labels = step.block(p_dev[r0:r0 + chunk])
        if labels_out is not None:
            _write_labels(labels_out, r0, dev.from_device(labels),
                          write_tickets)
    write_tickets.wait_all()
    if labels_out is not None:
        labels_out.store.flush()
    return step.finish(p_norm2)


def _sample_indices(n: int, s: int, rng) -> np.ndarray:
    """s distinct sorted indices from [0, n) in O(s) memory
    (rng.choice(replace=False) permutes the whole population — O(n) host
    memory, fatal for out-of-core point counts)."""
    if s >= n:
        return np.arange(n, dtype=np.int64)
    picked = np.unique(rng.integers(0, n, int(s * 1.2) + 16))
    while len(picked) < s:
        extra = rng.integers(0, n, s)
        picked = np.unique(np.concatenate([picked, extra]))
    return picked[np.sort(rng.choice(len(picked), s, replace=False))] \
        if len(picked) > s else picked


def gather_rows(points: FlashArray, idx: np.ndarray) -> np.ndarray:
    """Gather sorted row indices from a flash matrix in contiguous runs
    (one strided read per run instead of one per row)."""
    d = points.shape[1]
    out = np.empty((len(idx), d), points.dtype)
    start = 0
    while start < len(idx):
        end = start + 1
        while end < len(idx) and idx[end] == idx[end - 1] + 1:
            end += 1
        out[start:end] = points.read_block(int(idx[start]),
                                           end - start, 0, d)
        start = end
    return out


def _kmeanspp_sample(points: FlashArray, n_centers: int, rng,
                     sample_cap: int = 1 << 16) -> np.ndarray:
    """k-means++ seeding on a uniform sample of the flash points (a full
    k-means++ pass would re-stream the data k times; the sampled variant
    is the standard out-of-core compromise).  Draws bof_tpu's random
    numbers in bof_tpu's order, so one seed gives both the same centers."""
    n, d = points.shape
    s = min(n, max(sample_cap, 16 * n_centers))
    idx = _sample_indices(n, s, rng)
    sample = gather_rows(points, idx)
    sample64 = sample.astype(np.float64)

    def sq_dist(center):
        # bof_tpu's ((sample - center) ** 2).sum(1), the same operations on
        # each row (so the same bits), a cache-sized row block at a time
        out = np.empty(s)
        for r0 in range(0, s, 2048):
            t = sample64[r0:r0 + 2048] - center
            np.multiply(t, t, out=t)
            out[r0:r0 + 2048] = t.sum(1)
        return out
    centers = np.empty((n_centers, d), np.float64)
    centers[0] = sample[rng.integers(0, s)]
    d2 = sq_dist(centers[0])
    for c in range(1, n_centers):
        total = d2.sum()
        if total <= 0:
            centers[c:] = sample[rng.choice(s, n_centers - c)]
            break
        pick = int(np.searchsorted(np.cumsum(d2), rng.random() * total))
        centers[c] = sample[min(pick, s - 1)]
        np.minimum(d2, sq_dist(centers[c]), out=d2)
    return centers.astype(points.dtype)


def kmeans_fit(points: FlashArray, n_centers: int, n_iters: int = 10,
               seed: int = 0, tol: float = 0.0, init: str = "kmeans++",
               n_init: int = 1, labels_out: Optional[FlashArray] = None,
               state_path: Optional[str] = None,
               ctx=None) -> Tuple[np.ndarray, float]:
    """Full Lloyd's loop (reference: drivers/kmeans.cpp main loop).
    init='kmeans++' seeds on a point sample; init='random' picks random
    distinct points (the reference's seeding).  n_init > 1 runs multiple
    restarts and keeps the lowest-inertia fit.

    Device tier: when 3 * n * d * 4 bytes fit the device budget (and the
    float32 panel the host budget) the points upload ONCE and every
    iteration slices the resident panel.

    `state_path` makes the fit checkpointable: each completed iteration
    atomically saves (attempt, iter, centers, best) in bof_tpu's format, so
    a state either package wrote resumes in the other; a rerun resumes
    mid-attempt from the last finished iteration.  The file is removed on
    completion."""
    import os
    ctx = ctx or points.ctx or get_context()
    cfg = ctx.config
    n, d = points.shape
    timer = Timer()
    p_dev = None
    p_norm2 = 0.0
    if (points.order == "R" and n_iters > 1
            # fp64 streams through the exact host step in lloyds_iter
            and points.dtype != np.float64
            and dev.dtype_native_on_device(points.dtype)
            and 3 * n * d * 4 <= cfg.hbm_budget
            # the upload stages one full float32 panel in host DRAM
            and n * d * 4 <= cfg.program_budget):
        p_dev, p_norm2 = _device_points(points, ctx)

    def one_iter(centers, labels_out=None):
        if p_dev is not None:
            return _lloyds_iter_device(p_dev, p_norm2, centers,
                                       labels_out=labels_out, ctx=ctx)
        return lloyds_iter(points, centers, labels_out=labels_out, ctx=ctx)

    def save_state(attempt, it, centers, best):
        tmp = state_path + ".tmp.npz"  # .npz suffix: savez won't rename it
        np.savez(tmp, attempt=attempt, it=it, centers=centers,
                 best_inertia=best[0],
                 best_centers=(best[1] if best[1] is not None
                               else np.zeros((0, 0))))
        os.replace(tmp, state_path)

    best: Tuple[float, np.ndarray] = (np.inf, None)
    start_attempt, start_it = 0, 0
    resume_centers = None
    if state_path and os.path.exists(state_path):
        with np.load(state_path) as st:
            start_attempt = int(st["attempt"])
            start_it = int(st["it"]) + 1
            resume_centers = st["centers"].astype(points.dtype)
            if st["best_centers"].size:
                best = (float(st["best_inertia"]),
                        st["best_centers"].astype(points.dtype))
        LOG.info("kmeans_fit: resuming from %s at attempt %d iter %d",
                 state_path, start_attempt, start_it)
    for attempt in range(start_attempt, max(1, n_init)):
        rng = np.random.default_rng(seed + attempt)
        with METRICS.span("kmeans.seed"):
            if attempt == start_attempt and resume_centers is not None:
                centers = resume_centers
            elif init == "kmeans++":
                centers = _kmeanspp_sample(points, n_centers, rng)
            else:
                idx = _sample_indices(n, n_centers, rng)
                centers = np.stack([points.read_block(int(i), 1, 0, d)[0]
                                    for i in idx])
        inertia = np.inf
        it0 = start_it if attempt == start_attempt else 0
        for it in range(it0, n_iters):
            centers_new, inertia, _ = one_iter(centers)
            shift = float(((centers_new - centers) ** 2).sum())
            centers = centers_new
            LOG.debug("kmeans[%d] iter %d: inertia %.6g shift %.3g "
                      "(%.0f ms)", attempt, it, inertia, shift,
                      timer.elapsed_ms())
            if state_path:
                save_state(attempt, it, centers, best)
            if shift <= tol:
                break
        if not np.isfinite(inertia):
            # resumed past this attempt's last iteration (or n_iters=0):
            # one evaluation pass so the attempt still scores into `best`
            _, inertia, _ = one_iter(centers)
        if inertia < best[0]:
            best = (inertia, centers)
    inertia, centers = best
    if labels_out is not None:
        # final assignment pass against the winning centers (also covers
        # early convergence)
        _, inertia, _ = one_iter(centers, labels_out=labels_out)
    if state_path and os.path.exists(state_path):
        os.unlink(state_path)  # state consumed on completion
    return centers, inertia


def kmeans_in_mem(points_np: np.ndarray, centers0: np.ndarray,
                  n_iters: int = 1) -> Tuple[np.ndarray, float]:
    """Golden model (reference: drivers/in_mem_kmeans.cpp) — plain numpy
    Lloyd's on fully-resident data."""
    pts = points_np.astype(np.float64)
    centers = centers0.astype(np.float64)
    inertia = np.inf
    for _ in range(n_iters):
        d2 = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        labels = d2.argmin(1)
        inertia = float(d2.min(1).sum())
        for c in range(len(centers)):
            sel = labels == c
            if sel.any():
                centers[c] = pts[sel].mean(0)
    return centers.astype(centers0.dtype), inertia
