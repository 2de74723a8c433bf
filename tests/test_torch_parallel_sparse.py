"""The port's csrmm_sharded against bof_tpu's, on gloo ranks.

Every csrmm case of tests/test_parallel.py runs through both packages on
the same seeded CSR matrix and dense panels: bof_tpu's csrmm_sharded in
this process on the virtual CPU mesh of tests/conftest.py (`make_mesh(n)`),
the port's on a world of n gloo ranks (tests/torch_dist_pool.py) reading
the CSR triplet and B from files and writing C rows into one shared file.
A 2x2 mesh, the 6-rank (2x3) case with its uneven rows, and a world of one
rank for the whole-block path with count-sorted bands.  Tolerances: rtol
2e-4 (atol 1e-4 to 2e-4, as the reference tests) against scipy and
bof_tpu; the port's two read paths bit for bit in a world of one rank.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sps

import bof_tpu
import torch_dist_jobs as jobs
from torch_dist_pool import Pools

WORLD = 4  # 2 x 2


@pytest.fixture(scope="module")
def pools():
    p = Pools()
    yield p
    p.close()


def _write(ctx, path, data, order="R"):
    arr = bof_tpu.map_array(path, data.shape, data.dtype, order,
                            create=True, ctx=ctx)
    arr.write_all(data)
    return (os.path.basename(path), data.shape, data.dtype.str, order)


def _read(ctx, workdir, spec):
    name, shape, dtype, order = spec
    return bof_tpu.map_array(os.path.join(workdir, name), shape,
                             np.dtype(dtype), order, ctx=ctx).read_all()


def _csr_files(ctx, workdir, a_sp, prefix="A"):
    from bof_tpu.sparse import CsrFlashMatrix
    return CsrFlashMatrix.from_scipy(a_sp, backing="file",
                                     path_prefix=os.path.join(workdir,
                                                              prefix),
                                     ctx=ctx)


def _ref_csrmm(ctx, A, b_np, c0_np, order, world, forced=False, **kw):
    """bof_tpu's csrmm_sharded on a make_mesh(world) mesh, in memory."""
    import bof_tpu.parallel.mesh as meshmod
    from bof_tpu import mem_array
    from bof_tpu.parallel import csrmm_sharded, make_mesh
    B = mem_array(b_np.shape, np.float32, data=b_np, ctx=ctx)
    C = mem_array(c0_np.shape, np.float32, order=order, data=c0_np,
                  ctx=ctx)
    meshmod._FORCE_SHARDED_READS = forced
    try:
        csrmm_sharded(A, B, C, mesh=make_mesh(world), ctx=ctx, **kw)
    finally:
        meshmod._FORCE_SHARDED_READS = False
    return C.read_all()


def test_csrmm_sharded_six_devices(pools, ctx, rng, tmp_path):
    """Six ranks: rows_pad divides over the flattened 6-rank axis
    (min_rows = lcm(8, 6)), against bof_tpu's 6-device mesh on both its
    read paths."""
    m, k, n = 300, 90, 16
    a_sp = sps.random(m, k, density=0.05, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(3))
    A = _csr_files(ctx, str(tmp_path), a_sp)
    b_np = rng.standard_normal((k, n)).astype(np.float32)
    b = _write(ctx, str(tmp_path / "B"), b_np)
    c = _write(ctx, str(tmp_path / "C"), np.zeros((m, n), np.float32))
    pools.get(6).run(jobs.csrmm, str(tmp_path), "A", (m, k), b, c, {})
    got = _read(ctx, str(tmp_path), c)
    want = (a_sp @ b_np).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for forced in (False, True):
        ref = _ref_csrmm(ctx, A, b_np, np.zeros((m, n), np.float32), "R", 6,
                         forced)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world,shape", [(6, (2, 3)), (4, (2, 2))])
def test_make_mesh_shapes(pools, tmp_path, world, shape):
    """bof_tpu's near-square rule, rank r at (r // py, r % py), and a
    mesh larger than the world raises on every rank."""
    from bof_tpu.parallel import make_mesh as ref_make_mesh
    assert tuple(ref_make_mesh(world).devices.shape) == shape
    out = pools.get(world).run(jobs.mesh_info, str(tmp_path))
    for r, (got_shape, names, coord, err) in enumerate(out):
        assert got_shape == shape and names == ("x", "y")
        assert coord == (r // shape[1], r % shape[1])
        assert f"need {world + 1} devices" in err


def test_csrmm_sharded_matches_scipy(pools, ctx, rng, tmp_path):
    """Row-sharded sparse x dense over the 2x2 mesh, several row blocks,
    alpha and beta."""
    ctx.config.max_nnzs = 4096
    m, k, n = 500, 200, 48
    a_sp = sps.random(m, k, density=0.05, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(5))
    A = _csr_files(ctx, str(tmp_path), a_sp)
    b_np = rng.standard_normal((k, n)).astype(np.float32)
    c0_np = rng.standard_normal((m, n)).astype(np.float32)
    b = _write(ctx, str(tmp_path / "B"), b_np)
    c = _write(ctx, str(tmp_path / "C"), c0_np)
    pools.get(WORLD).run(jobs.csrmm, str(tmp_path), "A", (m, k), b, c,
                         {"alpha": 2.0, "beta": 0.5}, {"max_nnzs": 4096})
    got = _read(ctx, str(tmp_path), c)
    want = 2.0 * (a_sp @ b_np) + 0.5 * c0_np
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
    ref = _ref_csrmm(ctx, A, b_np, c0_np, "R", WORLD, alpha=2.0, beta=0.5)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-4)


def _skewed(rng, m=600, k=150):
    a_sp = sps.random(m, k, density=0.04, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(9)).tolil()
    a_sp[37, :] = rng.standard_normal(k)  # mega-row skews the ELL ranges
    a_sp[411, :100] = 1.0
    return a_sp.tocsr()


SKEW_CFG = {"max_nnzs": 4096, "hbm_budget": 1 << 10,
            "ell_sort_rows": False}


def test_csrmm_sharded_sharded_reads_match(pools, ctx, rng, tmp_path):
    """The per-rank read path (each rank's nnz sub-reads, the global ELL
    dims every rank derives from ia) with skewed rows, several ELL
    sub-ranges (a tiny device budget), alpha/beta and both C orders,
    against bof_tpu's forced sharded reads and whole-block path."""
    for key, val in SKEW_CFG.items():
        setattr(ctx.config, key, val)
    m, k, n = 600, 150, 40
    a_sp = _skewed(rng, m, k)
    A = _csr_files(ctx, str(tmp_path), a_sp)
    b_np = rng.standard_normal((k, n)).astype(np.float32)
    c0_np = rng.standard_normal((m, n)).astype(np.float32)
    b = _write(ctx, str(tmp_path / "B"), b_np)
    want = 1.5 * (a_sp @ b_np) + 0.25 * c0_np
    for order in ("R", "C"):
        c = _write(ctx, str(tmp_path / f"C{order}"), c0_np, order)
        pools.get(WORLD).run(jobs.csrmm, str(tmp_path), "A", (m, k), b, c,
                             {"alpha": 1.5, "beta": 0.25}, SKEW_CFG)
        got = _read(ctx, str(tmp_path), c)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)
        for forced in (False, True):
            ref = _ref_csrmm(ctx, A, b_np, c0_np, order, WORLD, forced,
                             alpha=1.5, beta=0.25)
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("order", ["R", "C"])
def test_csrmm_sharded_one_rank_paths(pools, ctx, rng, tmp_path, order):
    """A world of one rank: the whole-block path (count-sorted bands, K2
    writing each band's rows in place) against scipy and bof_tpu's
    make_mesh(1); with banding off, its per-rank read path (forced) gives
    the same bits as the whole-block path."""
    m, k, n = 600, 150, 40
    a_sp = _skewed(rng, m, k)
    A = _csr_files(ctx, str(tmp_path), a_sp)
    b_np = rng.standard_normal((k, n)).astype(np.float32)
    c0_np = rng.standard_normal((m, n)).astype(np.float32)
    b = _write(ctx, str(tmp_path / "B"), b_np)
    c = _write(ctx, str(tmp_path / "C"), c0_np, order)
    kw = {"alpha": 1.5, "beta": 0.25}
    pools.get(1).run(jobs.csrmm, str(tmp_path), "A", (m, k), b, c, kw,
                     {"max_nnzs": 4096})
    got = _read(ctx, str(tmp_path), c)
    want = 1.5 * (a_sp @ b_np) + 0.25 * c0_np
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)
    ctx.config.max_nnzs = 4096
    ref = _ref_csrmm(ctx, A, b_np, c0_np, order, 1, **kw)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)
    paths = []
    for forced in (False, True):
        c = _write(ctx, str(tmp_path / f"C{forced}"), c0_np, order)
        pools.get(1).run(jobs.csrmm, str(tmp_path), "A", (m, k), b, c, kw,
                         SKEW_CFG, forced)
        paths.append(_read(ctx, str(tmp_path), c))
    np.testing.assert_array_equal(paths[0], paths[1])
    np.testing.assert_allclose(paths[0], want, rtol=2e-4, atol=1e-3)
