"""The port's data-parallel Lloyd steps against bof_tpu's, on gloo ranks.

Every k-means case of tests/test_parallel.py runs through both packages on
the same seeded points: bof_tpu's in this process on the virtual CPU mesh
of tests/conftest.py (`make_mesh(4)`, 2x2), the port's on a world of 4
gloo ranks (tests/torch_dist_pool.py), each rank running B7's plain
version on its own point rows and writing its label rows into one shared
file; a world of one rank covers the whole-block read path.  Tolerances:
labels equal but for float64 near-ties (two centers within 1e-5 of the
point's distance scale), centers rtol 1e-4 (atol 1e-4), inertia rtol 1e-4.
"""
import os

import numpy as np
import pytest

import bof_tpu
import torch_dist_jobs as jobs
from torch_dist_pool import Pools

WORLD = 4  # 2 x 2


@pytest.fixture(scope="module")
def pools():
    p = Pools()
    yield p
    p.close()


def _write(ctx, path, data):
    arr = bof_tpu.map_array(path, data.shape, data.dtype, create=True,
                            ctx=ctx)
    arr.write_all(data)
    return (os.path.basename(path), data.shape, data.dtype.str, "R")


def _read(ctx, workdir, spec):
    name, shape, dtype, _ = spec
    return bof_tpu.map_array(os.path.join(workdir, name), shape,
                             np.dtype(dtype), ctx=ctx).read_all()


def _labels_match(got, want, pts, centers):
    """Equal labels but where the two centers stand within 1e-5 of each
    other's distance from the point (a float64 near-tie)."""
    diff = np.flatnonzero(got != want)
    if diff.size:
        p = pts[diff].astype(np.float64)
        c = centers.astype(np.float64)
        dg = ((p - c[got[diff]]) ** 2).sum(1)
        dw = ((p - c[want[diff]]) ** 2).sum(1)
        scale = (p ** 2).sum(1) + (c ** 2).sum(1).max()
        assert (np.abs(dg - dw) <= 1e-5 * scale).all(), diff
    assert diff.size <= max(1, got.size // 100)


def test_dp_lloyd_matches_single_device(pools, ctx, rng, tmp_path):
    """lloyds_iter_sharded on host points (1003 rows: not divisible by the
    ranks, so the last rank holds fewer real rows and no pad row reaches a
    center), against bof_tpu's and the in-memory golden."""
    from bof_tpu.ops.kmeans import kmeans_in_mem
    from bof_tpu.parallel import lloyds_iter_sharded, make_mesh
    n, d, k = 1003, 16, 5
    pts = rng.standard_normal((n, d)).astype(np.float32)
    c0 = pts[:k].copy()
    out = pools.get(WORLD).run(jobs.lloyd_host, str(tmp_path), pts, c0)
    got_c, got_i, counts = out[0]
    for o in out[1:]:
        np.testing.assert_array_equal(o[0], got_c)
    ref_c, ref_i, ref_n = lloyds_iter_sharded(pts, c0, mesh=make_mesh(WORLD))
    want_c, want_i = kmeans_in_mem(pts, c0, n_iters=1)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_c, ref_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_i, want_i, rtol=1e-4)
    np.testing.assert_allclose(got_i, float(ref_i), rtol=1e-4)
    np.testing.assert_array_equal(counts, ref_n)
    assert counts.sum() == n


def _ooc_case(ctx, tmp_path, rng, n=437, d=12, kc=5):
    pts = rng.standard_normal((n, d)).astype(np.float32)
    c0 = pts[rng.choice(n, kc, replace=False)].copy()
    p = _write(ctx, str(tmp_path / "P"), pts)
    lab = _write(ctx, str(tmp_path / "L"), np.full(n, -1, np.int32))
    return pts, c0, p, lab


def test_lloyds_iter_ooc_sharded_matches_single_chip(pools, ctx, rng,
                                                      tmp_path):
    """Streamed flash-resident points, 64-row blocks ragged against the
    ranks: statistics and written labels against bof_tpu's mesh pass and
    its one-chip lloyds_iter."""
    from bof_tpu import flash_empty, mem_array
    from bof_tpu.ops.kmeans import lloyds_iter
    from bof_tpu.parallel import lloyds_iter_ooc_sharded, make_mesh
    pts, c0, p, lab = _ooc_case(ctx, tmp_path, rng)
    n = len(pts)
    out = pools.get(WORLD).run(jobs.lloyd_ooc, str(tmp_path), p, c0, lab,
                               {"blk_rows": 64})
    got_c, got_i, got_n = out[0]
    got_l = _read(ctx, str(tmp_path), lab)
    P = mem_array(pts.shape, np.float32, data=pts, ctx=ctx)
    lab_a, lab_b = (flash_empty((n,), np.int32, ctx=ctx) for _ in range(2))
    want_c, want_i, want_n = lloyds_iter(P, c0, labels_out=lab_a,
                                         blk_rows=64, ctx=ctx)
    ref_c, ref_i, ref_n = lloyds_iter_ooc_sharded(
        P, c0, labels_out=lab_b, mesh=make_mesh(WORLD), blk_rows=64,
        ctx=ctx)
    for c, i, cnt in ((want_c, want_i, want_n), (ref_c, ref_i, ref_n)):
        np.testing.assert_allclose(got_c, c, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got_i, i, rtol=1e-4)
        np.testing.assert_array_equal(got_n, cnt)
    _labels_match(got_l, lab_a.read_all(), pts, c0)
    _labels_match(got_l, lab_b.read_all(), pts, c0)


def test_kmeans_fit_sharded_converges(pools, ctx, rng, tmp_path):
    """Three well-separated blobs: the mesh fit recovers each center, as
    bof_tpu's does, from bof_tpu's k-means++ seeds (the same bits)."""
    from bof_tpu import flash_empty, mem_array
    from bof_tpu.parallel import kmeans_fit_sharded, make_mesh
    blobs = [rng.standard_normal((100, 4)).astype(np.float32) + 10 * i
             for i in range(3)]
    pts = np.concatenate(blobs)
    rng.shuffle(pts)
    p = _write(ctx, str(tmp_path / "P"), pts)
    lab = _write(ctx, str(tmp_path / "L"), np.full(300, -1, np.int32))
    out = pools.get(WORLD).run(jobs.kmeans_fit, str(tmp_path), p, lab, 3,
                               {"n_iters": 8, "seed": 1})
    centers, inertia = out[0][:2]
    got = np.sort(centers.mean(axis=1))
    np.testing.assert_allclose(got, np.sort([b.mean() for b in blobs]),
                               atol=0.5)
    got_l = _read(ctx, str(tmp_path), lab)
    assert set(np.unique(got_l)) == {0, 1, 2}
    P = mem_array((300, 4), np.float32, data=pts, ctx=ctx)
    L = flash_empty((300,), np.int32, ctx=ctx)
    ref_c, ref_i = kmeans_fit_sharded(P, 3, n_iters=8, seed=1, labels_out=L,
                                      mesh=make_mesh(WORLD), ctx=ctx)
    np.testing.assert_allclose(centers, ref_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(inertia, ref_i, rtol=1e-4)
    _labels_match(got_l, L.read_all(), pts, ref_c)


def test_kmeans_fit_sharded_resident_matches_streaming(pools, ctx, rng,
                                                       tmp_path):
    """The resident tier (each rank uploads the rows it would stream once,
    at any world size) against the streaming tier (a tiny device budget
    denies residency: one upload a pass), bit for bit, and both against
    bof_tpu's resident fit; 4003 rows, not a multiple of the ranks."""
    from bof_tpu import mem_array
    from bof_tpu.parallel import kmeans_fit_sharded, make_mesh
    n, d, k = 4003, 6, 4
    pts = (rng.standard_normal((n, d)) * 0.05
           + rng.integers(0, k, n)[:, None]).astype(np.float32)
    p = _write(ctx, str(tmp_path / "P"), pts)
    labs = [_write(ctx, str(tmp_path / f"L{i}"), np.full(n, -1, np.int32))
            for i in range(2)]
    kw = {"n_iters": 4, "seed": 2, "tol": -1.0}
    res = pools.get(WORLD).run(jobs.kmeans_fit, str(tmp_path), p, labs[0],
                               k, kw)
    st = pools.get(WORLD).run(jobs.kmeans_fit, str(tmp_path), p, labs[1],
                              k, kw, {"hbm_budget": 1 << 6})
    rows = [len(range(n)[r * 1001:(r + 1) * 1001]) for r in range(WORLD)]
    assert [o[3] for o in res] == [r * d * 4 for r in rows]  # once
    assert [o[3] for o in st] == [4 * r * d * 4 for r in rows]  # a pass
    # the resident tier keeps the blocks the streamed one reads: the same
    # arithmetic, the same bits
    np.testing.assert_array_equal(res[0][0], st[0][0])
    assert res[0][1] == st[0][1]
    np.testing.assert_array_equal(_read(ctx, str(tmp_path), labs[0]),
                                  _read(ctx, str(tmp_path), labs[1]))
    P = mem_array((n, d), np.float32, data=pts, ctx=ctx)
    L = mem_array((n,), np.int32, ctx=ctx)
    ref_c, ref_i = kmeans_fit_sharded(P, k, labels_out=L,
                                      mesh=make_mesh(WORLD), ctx=ctx, **kw)
    np.testing.assert_allclose(res[0][0], ref_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res[0][1], ref_i, rtol=1e-4)
    _labels_match(_read(ctx, str(tmp_path), labs[0]), L.read_all(), pts,
                  ref_c)


def test_lloyds_ooc_sharded_reads_match(pools, ctx, rng, tmp_path):
    """The per-rank read path (4 ranks) against the whole-block path and
    the forced per-rank path of a world of one rank: statistics and
    written labels, ragged blocks and tails; all against the one-chip
    golden."""
    from bof_tpu import mem_array
    from bof_tpu.ops.kmeans import lloyds_iter
    pts, c0, p, lab = _ooc_case(ctx, tmp_path, rng)
    runs = []
    for world, forced in ((WORLD, False), (1, False), (1, True)):
        out = pools.get(world).run(jobs.lloyd_ooc, str(tmp_path), p, c0, lab,
                                   {"blk_rows": 64}, forced)
        runs.append((out[0], _read(ctx, str(tmp_path), lab)))
    (c4, i4, n4), l4 = runs[0]
    for (c, i, cnt), lab_np in runs[1:]:
        np.testing.assert_allclose(c, c4, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(cnt, n4)
        np.testing.assert_array_equal(lab_np, l4)
    np.testing.assert_array_equal(runs[1][0][0], runs[2][0][0])
    P = mem_array(pts.shape, np.float32, data=pts, ctx=ctx)
    want_c, want_i, want_n = lloyds_iter(P, c0, blk_rows=64, ctx=ctx)
    np.testing.assert_allclose(c4, want_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(i4, want_i, rtol=1e-4)
    np.testing.assert_allclose(n4, want_n)
