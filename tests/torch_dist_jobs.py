"""Rank-side jobs of the port's multi-rank tests (run by torch_dist_pool).

Every job is `job(rank, world, workdir, ...)`: it opens a FlashContext on
the CPU with a scratch directory of its own under `workdir`, builds the
mesh over the pool's gloo world, runs one of bof_tpu_torch's sharded
functions on operand files the test wrote under `workdir`, and returns
what the test compares (output files are read by the test itself).  This
module imports torch, numpy and bof_tpu_torch only.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np

from torch_dist_pool import scratch_of


@contextlib.contextmanager
def flash_ctx(workdir: str, rank: int, **cfg):
    import bof_tpu_torch as bt
    kw = dict(device="cpu", scratch_dir=scratch_of(workdir, rank),
              n_io_threads=2, n_compute_threads=1, program_budget=64 << 20,
              pipeline_depth=2)
    kw.update(cfg)
    ctx = bt.FlashContext(bt.FlashConfig(**kw))
    try:
        yield ctx
    finally:
        ctx.destroy()


def _mesh(n=None):
    from bof_tpu_torch.parallel import make_mesh
    return make_mesh(n, device="cpu")


def _dense(ctx, workdir, spec):
    """A FlashArray over a file the test wrote: spec (name, shape, dtype,
    order)."""
    from bof_tpu_torch import map_array
    name, shape, dtype, order = spec
    return map_array(os.path.join(workdir, name), tuple(shape),
                     np.dtype(dtype), order, ctx=ctx)


def _csr(ctx, workdir, prefix, shape, val_dtype=np.float32):
    from bof_tpu_torch import CsrFlashMatrix
    return CsrFlashMatrix.map_files(os.path.join(workdir, prefix), shape,
                                    val_dtype=val_dtype, ctx=ctx)


@contextlib.contextmanager
def _forced(flag: bool):
    import bof_tpu_torch.parallel.mesh as pm
    pm._FORCE_SHARDED_READS = flag
    try:
        yield
    finally:
        pm._FORCE_SHARDED_READS = False


def _metric(name: str) -> float:
    from bof_tpu_torch.utils import METRICS
    return METRICS.get(name)


# ------------------------------------------------------------------ mesh

def mesh_info(rank, world, workdir):
    """(shape, axis names, coordinate, message of make_mesh(world + 1))."""
    mesh = _mesh()
    try:
        _mesh(world + 1)
        err = None
    except ValueError as e:
        err = str(e)
    return (tuple(mesh.shape), tuple(mesh.mesh_dim_names),
            tuple(mesh.get_coordinate()), err)


def accum_step(rank, world, workdir, a, b, c, alpha):
    """This rank's shards of full (bm, bk) x (bk, bn) tiles through
    sharded_accum_step: (its C box, its updated C shard)."""
    import torch
    from bof_tpu_torch.parallel.mesh import (_specs, sharded_accum_step,
                                             sharding_for)
    mesh = _mesh()
    sa, sb_, sc = (sharding_for(mesh, s) for s in _specs(False, False,
                                                          False))
    box = sc.box(c.shape)
    step = sharded_accum_step(mesh)
    out = step(torch.from_numpy(c[box].copy()),
               torch.from_numpy(a[sa.box(a.shape)].copy()),
               torch.from_numpy(b[sb_.box(b.shape)].copy()), alpha)
    return [(s.start, s.stop) for s in box], out.numpy()


def writeback(rank, world, workdir, x, tile, c_spec, i0, j0, bi, bj):
    """device_put_sharded of x under every spec, and this rank's shard of
    `tile` written back into C (c_spec) with _writeback_shards."""
    from bof_tpu_torch.parallel.mesh import (_writeback_shards,
                                             device_put_sharded,
                                             sharding_for)
    mesh = _mesh()
    puts = []
    for spec in (("x", "y"), ("y", None), (None, "y"), ()):
        sh = sharding_for(mesh, spec)
        puts.append(([(s.start, s.stop) for s in sh.box(x.shape)],
                     device_put_sharded(x, sh).numpy()))
    with flash_ctx(workdir, rank) as ctx:
        c = _dense(ctx, workdir, c_spec)
        sh_c = sharding_for(mesh, ("x", "y") if c.order == "R"
                            else ("y", "x"))
        rows, cols = sh_c.box(tile.shape)
        for t in _writeback_shards(tile[rows, cols], c, i0, j0, bi, bj,
                                   (rows.start, rows.stop, cols.start,
                                    cols.stop)):
            t.wait()
        c.store.flush()
    from bof_tpu_torch.parallel.mesh import barrier
    barrier()
    return puts


# ------------------------------------------------------------------- gemm

def gemm(rank, world, workdir, a, b, c, kw, cfg=None, forced=False,
         fp64=False):
    """gemm_sharded (gemm64 with `fp64`) over files; returns the B-shard
    device hits."""
    from bof_tpu_torch import gemm64
    from bof_tpu_torch.parallel import gemm_sharded
    with flash_ctx(workdir, rank, **(cfg or {})) as ctx:
        A, B, C = (_dense(ctx, workdir, s) for s in (a, b, c))
        hits = _metric("gemm_sharded.b_hbm_hits")
        with _forced(forced):
            fn = gemm64 if fp64 else gemm_sharded
            fn(A, B, C, mesh=_mesh(), ctx=ctx, **kw)
        return _metric("gemm_sharded.b_hbm_hits") - hits


def pin_failure(rank, world, workdir, a, b, c):
    """A program budget below four tiles must raise MemoryError on every
    rank, not hang."""
    from bof_tpu_torch.parallel import gemm_sharded
    with flash_ctx(workdir, rank, program_budget=1 << 10) as ctx:
        A, B, C = (_dense(ctx, workdir, s) for s in (a, b, c))
        try:
            gemm_sharded(A, B, C, blk=64, mesh=_mesh(), ctx=ctx)
        except MemoryError as e:
            return f"MemoryError: {e}"
    return "no error"


# ----------------------------------------------------------------- sparse

def csrmm(rank, world, workdir, a_prefix, a_shape, b, c, kw, cfg=None,
          forced=False):
    from bof_tpu_torch.parallel import csrmm_sharded
    with flash_ctx(workdir, rank, **(cfg or {})) as ctx:
        A = _csr(ctx, workdir, a_prefix, a_shape)
        B, C = _dense(ctx, workdir, b), _dense(ctx, workdir, c)
        with _forced(forced):
            csrmm_sharded(A, B, C, mesh=_mesh(), ctx=ctx, **kw)
    return True


# ----------------------------------------------------------------- kmeans

def lloyd_host(rank, world, workdir, pts, c0):
    from bof_tpu_torch.parallel import lloyds_iter_sharded
    return lloyds_iter_sharded(pts, c0, mesh=_mesh())


def lloyd_ooc(rank, world, workdir, p, c0, labels, kw, forced=False):
    from bof_tpu_torch.parallel import lloyds_iter_ooc_sharded
    with flash_ctx(workdir, rank) as ctx:
        P = _dense(ctx, workdir, p)
        L = _dense(ctx, workdir, labels) if labels else None
        with _forced(forced):
            return lloyds_iter_ooc_sharded(P, c0, labels_out=L,
                                           mesh=_mesh(), ctx=ctx, **kw)


def kmeans_fit(rank, world, workdir, p, labels, n_centers, kw, cfg=None):
    """kmeans_fit_sharded; also returns the B7 assign launches and the
    bytes of points uploaded (one panel when resident)."""
    from bof_tpu_torch.ops.kmeans import lloyd_assign
    from bof_tpu_torch.parallel import kmeans_fit_sharded
    with flash_ctx(workdir, rank, **(cfg or {})) as ctx:
        P = _dense(ctx, workdir, p)
        L = _dense(ctx, workdir, labels) if labels else None
        h2d = _metric("kmeans.h2d_bytes")
        before = lloyd_assign.launches
        centers, inertia = kmeans_fit_sharded(P, n_centers, labels_out=L,
                                              mesh=_mesh(), ctx=ctx, **kw)
        return (centers, inertia, lloyd_assign.launches - before,
                _metric("kmeans.h2d_bytes") - h2d)


# ------------------------------------------------------------------- apps

def xml_rank(rank, world, workdir, a_prefix, a_shape, w, k, kw,
             merge_delay_s=0.0):
    """xml_rank(mesh=) on the rank; with `merge_delay_s`, rank 0 sleeps
    that long before each of its top-k merges, so the other ranks run
    ahead as far as the path lets them."""
    import importlib
    import time
    # the module: the package's `xml_rank` attribute is the function
    mod = importlib.import_module("bof_tpu_torch.apps.xml_rank")
    merge = mod._merge_topk

    def slow_merge(*args, **kwargs):
        time.sleep(merge_delay_s)
        return merge(*args, **kwargs)
    if merge_delay_s and rank == 0:
        mod._merge_topk = slow_merge
    try:
        with flash_ctx(workdir, rank) as ctx:
            A = _csr(ctx, workdir, a_prefix, a_shape)
            s, l = mod.xml_rank(A, _dense(ctx, workdir, w), k, mesh=_mesh(),
                                ctx=ctx, **kw)
            return s.read_all(), l.read_all()
    finally:
        mod._merge_topk = merge


def lanczos(rank, world, workdir, a_prefix, a_shape, n_vals, kw, cfg=None):
    from bof_tpu_torch.apps import block_lanczos_svd
    with flash_ctx(workdir, rank, **(cfg or {})) as ctx:
        A = _csr(ctx, workdir, a_prefix, a_shape)
        return block_lanczos_svd(A, n_vals, mesh=_mesh(), ctx=ctx, **kw)


def one_pass(rank, world, workdir, a_prefix, a_shape, v, cfg=None):
    from bof_tpu_torch.apps.eigensolver import _apply_ata_one_pass_sharded
    with flash_ctx(workdir, rank, **(cfg or {})) as ctx:
        A = _csr(ctx, workdir, a_prefix, a_shape)
        return _apply_ata_one_pass_sharded(A, v, _mesh(), ctx)


def topic_model(rank, world, workdir, a_prefix, a_shape, n_topics, kw,
                cfg=None):
    from bof_tpu_torch.apps import topic_model as run
    with flash_ctx(workdir, rank, **(cfg or {})) as ctx:
        A = _csr(ctx, workdir, a_prefix, a_shape)
        return run(A, n_topics, mesh=_mesh(), ctx=ctx, **kw)


def driver(rank, world, workdir, module, argv):
    """`python -m bof_tpu_torch.drivers.<module> argv...` on every rank, as
    torchrun runs it (the world is the pool's), with --device cpu and a
    scratch directory of the rank's own."""
    import importlib
    mod = importlib.import_module(f"bof_tpu_torch.drivers.{module}")
    return mod.main(list(argv) + ["--device", "cpu", "--scratch",
                                  scratch_of(workdir, rank)])


def data_plane(rank, world, workdir, v_op):
    """tests/mp_worker.py's program on every rank: gemm_sharded,
    csrmm_sharded, a sharded Lloyd pass, float64 gemm64(mesh=), the
    sharded one-pass operator and block Lanczos on it, over the files
    tests/test_multiprocess.py's layout names.  Returns (Lloyd centers,
    U, sigma, V)."""
    from bof_tpu_torch import gemm64
    from bof_tpu_torch.apps.eigensolver import (_apply_ata_one_pass_sharded,
                                                block_lanczos_svd)
    from bof_tpu_torch.parallel import (csrmm_sharded, gemm_sharded,
                                        lloyds_iter_ooc_sharded)
    mesh = _mesh()
    with flash_ctx(workdir, rank) as ctx:
        def arr(name, shape, dtype):
            return _dense(ctx, workdir, (name, shape, dtype, "R"))
        m, k, n = 90, 100, 70
        gemm_sharded(arr("A.bin", (m, k), "f4"), arr("B.bin", (k, n), "f4"),
                     arr("C_mp.bin", (m, n), "f4"), blk=32, mesh=mesh,
                     ctx=ctx)
        sm, sk, sn = 200, 64, 24
        As = _csr(ctx, workdir, "S", (sm, sk))
        csrmm_sharded(As, arr("SB.bin", (sk, sn), "f4"),
                      arr("SC_mp.bin", (sm, sn), "f4"), mesh=mesh, ctx=ctx)
        kp = arr("KP.bin", (165, 8), "f4")
        kc, _, _ = lloyds_iter_ooc_sharded(
            kp, kp.read_block(0, 4, 0, 8).copy(),
            labels_out=arr("KL_mp.bin", (165,), "i4"), mesh=mesh,
            blk_rows=64, ctx=ctx)
        gemm64(arr("A64.bin", (35, 33), "f8"), arr("B64.bin", (33, 40), "f8"),
               arr("C64_mp.bin", (35, 40), "f8"), blk=16, ctx=ctx, mesh=mesh)
        u = _apply_ata_one_pass_sharded(As, v_op, mesh, ctx)
        sigma, v = block_lanczos_svd(As, n_vals=3, max_kdim=24,
                                     n_restarts=4, seed=11, one_pass=True,
                                     mesh=mesh, ctx=ctx)
        return kc, u, sigma, v


def gemm_tiled(rank, world, workdir, a, b):
    """gemm_sharded on tile-major copies of a and b (tile 32, files of the
    rank's own): C, or the ValueError's message."""
    from bof_tpu_torch import map_tiled_array
    from bof_tpu_torch.parallel import gemm_sharded
    with flash_ctx(workdir, rank) as ctx:
        d = scratch_of(workdir, rank)
        arrs = []
        for nm, x in (("At", a), ("Bt", b),
                      ("Ct", np.zeros((a.shape[0], b.shape[1]),
                                      np.float32))):
            arr = map_tiled_array(os.path.join(d, nm), x.shape, np.float32,
                                  "R", tile=32, create=True, ctx=ctx)
            arr.write_all(x)
            arrs.append(arr)
        try:
            gemm_sharded(*arrs, blk=32, mesh=_mesh(), ctx=ctx)
        except ValueError as e:
            return str(e)
        return arrs[2].read_all()


def o_direct_writes(rank, world, workdir, what):
    """gemm_sharded, csrmm_sharded or a sharded Lloyd pass with O_DIRECT
    stores, on operands whose rank shards share 512-byte sectors."""
    from bof_tpu_torch.parallel import (csrmm_sharded, gemm_sharded,
                                        lloyds_iter_ooc_sharded)
    with flash_ctx(workdir, rank, use_o_direct=True, io_backend="native",
                   max_nnzs=2048) as ctx:
        if what == "gemm":
            gemm_sharded(*(_dense(ctx, workdir, (nm, (200, 200), "<f4", "R"))
                           for nm in "ABC"), blk=32, mesh=_mesh(), ctx=ctx)
        elif what == "csrmm":
            csrmm_sharded(_csr(ctx, workdir, "S", (3000, 200)),
                          _dense(ctx, workdir, ("SB", (200, 10), "<f4", "R")),
                          _dense(ctx, workdir, ("SC", (3000, 10), "<f4", "R")),
                          mesh=_mesh(), ctx=ctx)
        else:
            pts = _dense(ctx, workdir, ("P", (3001, 8), "<f4", "R"))
            lloyds_iter_ooc_sharded(
                pts, pts.read_block(0, 4, 0, 8).copy(),
                labels_out=_dense(ctx, workdir, ("L", (3001,), "<i4", "R")),
                mesh=_mesh(), blk_rows=500, ctx=ctx)
    return True
