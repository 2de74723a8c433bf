"""The port's mesh and sharded GEMM against bof_tpu's, on gloo ranks.

Every case of tests/test_parallel.py on the mesh and on gemm_sharded (and
tests/test_multiprocess.py's data plane) runs through both packages on the
same seeded operands: bof_tpu's sharded function in this process, on the
8-device virtual CPU mesh of tests/conftest.py (`make_mesh(n)`), and the
port's on a world of n gloo ranks spawned by tests/torch_dist_pool.py, one
process a rank, reading and writing the same files under tmp_path.  A 2x4
mesh unless a case says otherwise; a world of one rank covers the
whole-tile path.  Tolerances: fp32 rtol 2e-4 (atol 1e-4 to 1e-3, as the
reference tests) against bof_tpu and float64 numpy; the transfer modes
inside bof_tpu's bands (2e-2 bf16, 5e-2 int8 of max|C|); float64 within
bof_tpu's 1e-12 scaled bound.  The int32 output of K1 's8' (the sharded
int8 step's partial) is held bit for bit against numpy's int64 product.
"""
import os

import numpy as np
import pytest
import torch

import bof_tpu
import torch_dist_jobs as jobs
from torch_dist_pool import Pools

WORLD = 8  # bof_tpu's make_mesh(8): 2 x 4


@pytest.fixture(scope="module")
def pools():
    p = Pools()
    yield p
    p.close()


def _write(ctx, path, data, order="R"):
    """A file holding `data` (logical) in `order`, through bof_tpu; returns
    the port job's spec for it."""
    arr = bof_tpu.map_array(path, data.shape, data.dtype, order,
                            create=True, ctx=ctx)
    arr.write_all(data)
    return (os.path.basename(path), data.shape, data.dtype.str, order)


def _read(ctx, workdir, spec):
    name, shape, dtype, order = spec
    return bof_tpu.map_array(os.path.join(workdir, name), shape,
                             np.dtype(dtype), order, ctx=ctx).read_all()


def _gemm_case(ctx, tmp_path, rng, m, n, k, order="R", ta="N", tb="N",
               tag="", dtype=np.float32, c0=None):
    a_shape = (k, m) if ta == "T" else (m, k)
    b_shape = (n, k) if tb == "T" else (k, n)
    a = rng.standard_normal(a_shape).astype(dtype)
    b = rng.standard_normal(b_shape).astype(dtype)
    c = np.zeros((m, n), dtype) if c0 is None else c0
    w = str(tmp_path)
    specs = [_write(ctx, os.path.join(w, f"{nm}{tag}"), x, order)
             for nm, x in (("A", a), ("B", b), ("Cref", c), ("Cport", c))]
    return a, b, specs


def _ref_arrays(ctx, workdir, specs):
    name_a, name_b, name_c = specs[0], specs[1], specs[2]
    return [bof_tpu.map_array(os.path.join(workdir, s[0]), s[1],
                              np.dtype(s[2]), s[3], ctx=ctx)
            for s in (name_a, name_b, name_c)]


def _want(a, b, ta, tb, alpha=1.0, beta=0.0, c0=None):
    opa = (a.T if ta == "T" else a).astype(np.float64)
    opb = (b.T if tb == "T" else b).astype(np.float64)
    out = alpha * (opa @ opb)
    return out if c0 is None else out + beta * c0.astype(np.float64)


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("world,shape", [(8, (2, 4))])
def test_make_mesh_shapes(pools, tmp_path, world, shape):
    """bof_tpu's near-square rule over the world's ranks, rank r at
    (r // py, r % py); a mesh larger than the world raises on every rank
    (no virtual devices to fall back to)."""
    from bof_tpu.parallel import make_mesh as ref_make_mesh
    ref = ref_make_mesh(world)
    assert tuple(ref.devices.shape) == shape
    out = pools.get(world).run(jobs.mesh_info, str(tmp_path))
    for r, (got_shape, names, coord, err) in enumerate(out):
        assert got_shape == shape and names == ("x", "y")
        assert coord == (r // shape[1], r % shape[1])
        assert err is not None and f"need {world + 1} devices" in err


def test_make_mesh_for_a_card_without_one_raises():
    """A cuda mesh on a machine without a card raises at make_mesh (before
    any process group exists); nothing falls back to the CPU."""
    import torch.distributed as dist

    from bof_tpu_torch.parallel import make_mesh
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(device="cuda")
    assert not dist.is_initialized()


# ------------------------------------------------------------ the step

def test_sharded_accum_step_matches_dense(pools, tmp_path, rng):
    from bof_tpu.parallel import make_mesh, sharded_accum_step
    import jax.numpy as jnp
    mesh = make_mesh(WORLD)
    px, py = mesh.devices.shape
    bm = 16 * px * py
    a, b, c = (rng.standard_normal((bm, bm)).astype(np.float32)
               for _ in range(3))
    want_ref = np.asarray(sharded_accum_step(mesh)(
        jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), np.float32(2.0)))
    got = np.full_like(c, np.nan)
    for box, shard in pools.get(WORLD).run(jobs.accum_step, str(tmp_path),
                                           a, b, c, 2.0):
        (r0, r1), (c0, c1) = box
        got[r0:r1, c0:c1] = shard
    want = c + 2.0 * (a.astype(np.float64) @ b.astype(np.float64))
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, want_ref, rtol=2e-4, atol=1e-4)


# --------------------------------------------------------- gemm_sharded

def _run_both(pools, ctx, tmp_path, specs, world=WORLD, forced=False,
              **kw):
    from bof_tpu.parallel import gemm_sharded, make_mesh
    A, B, C = _ref_arrays(ctx, str(tmp_path), specs)
    gemm_sharded(A, B, C, mesh=make_mesh(WORLD), ctx=ctx, **kw)
    out = pools.get(world).run(jobs.gemm, str(tmp_path), specs[0], specs[1],
                               specs[3], kw, None, forced)
    return C.read_all(), _read(ctx, str(tmp_path), specs[3]), out


def test_gemm_sharded_out_of_core(pools, ctx, rng, tmp_path):
    a, b, specs = _gemm_case(ctx, tmp_path, rng, 96, 80, 112)
    ref, got, _ = _run_both(pools, ctx, tmp_path, specs, blk=32)
    want = _want(a, b, "N", "N").astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("order", ["R", "C"])
@pytest.mark.parametrize("ta,tb", [("N", "N"), ("T", "N"), ("N", "T"),
                                   ("T", "T")])
def test_gemm_sharded_all_layouts(pools, ctx, rng, tmp_path, order, ta, tb):
    """All 8 {order} x {transA} x {transB} configs, alpha and beta, ragged
    superblocks on every axis."""
    m, n, k = 96, 80, 112
    c0 = rng.standard_normal((m, n)).astype(np.float32)
    a, b, specs = _gemm_case(ctx, tmp_path, rng, m, n, k, order, ta, tb,
                             c0=c0)
    ref, got, _ = _run_both(pools, ctx, tmp_path, specs, alpha=1.5,
                            beta=0.5, transa=ta, transb=tb, blk=32)
    want = _want(a, b, ta, tb, 1.5, 0.5, c0).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-4)


def test_gemm_sharded_pin_failure_raises_not_hangs(pools, ctx, rng,
                                                    tmp_path):
    """A pin budget below four tiles raises MemoryError on every rank
    (bof_tpu's clamp), before any collective could wait for a dead rank."""
    from bof_tpu import FlashConfig, FlashContext, mem_array
    from bof_tpu.parallel import gemm_sharded, make_mesh
    _, _, specs = _gemm_case(ctx, tmp_path, rng, 64, 64, 64)
    small = FlashContext(FlashConfig(scratch_dir=ctx.config.scratch_dir,
                                     program_budget=1 << 10))
    try:
        A, B, C = (mem_array((64, 64), np.float32, ctx=small)
                   for _ in range(3))
        with pytest.raises(MemoryError):
            gemm_sharded(A, B, C, blk=64, mesh=make_mesh(WORLD), ctx=small)
    finally:
        small.destroy()
    out = pools.get(WORLD).run(jobs.pin_failure, str(tmp_path), specs[0],
                               specs[1], specs[3])
    assert all(o.startswith("MemoryError") for o in out), out


def test_gemm_sharded_b_tile_hbm_reuse(pools, ctx, rng, tmp_path):
    """j-outer/i-middle/l-inner: B shard (l, j) uploads once a j and is
    served from the device LRU for the other i sweeps, (mB-1)*kB*nB hits
    on every rank, as bof_tpu counts."""
    from bof_tpu.parallel import gemm_sharded, make_mesh
    from bof_tpu.utils import METRICS
    a, b, specs = _gemm_case(ctx, tmp_path, rng, 96, 96, 96)
    A, B, C = _ref_arrays(ctx, str(tmp_path), specs)
    before = METRICS.get("gemm_sharded.b_hbm_hits")
    gemm_sharded(A, B, C, blk=32, mesh=make_mesh(WORLD), ctx=ctx)
    assert METRICS.get("gemm_sharded.b_hbm_hits") - before == 2 * 3 * 3
    out = pools.get(WORLD).run(jobs.gemm, str(tmp_path), specs[0], specs[1],
                               specs[3], {"blk": 32})
    assert out == [2 * 3 * 3] * WORLD
    np.testing.assert_allclose(_read(ctx, str(tmp_path), specs[3]),
                               _want(a, b, "N", "N"), rtol=2e-4, atol=1e-3)


def test_multihost_helpers_match_device_put(pools, ctx, rng, tmp_path):
    """device_put_sharded's shards tile the array under every spec, and
    the ranks' _writeback_shards reassemble the exact C tile, both orders,
    ragged tails clipped on both axes."""
    sb = 32
    x = rng.standard_normal((sb, sb)).astype(np.float32)
    for order in ("R", "C"):
        c_spec = _write(ctx, str(tmp_path / f"C{order}"),
                        np.zeros((70, 50), np.float32), order)
        tile = rng.standard_normal((sb, sb)).astype(np.float32)
        i0, j0, bi, bj = 16, 16, 30, 20
        out = pools.get(WORLD).run(jobs.writeback, str(tmp_path), x, tile,
                                   c_spec, i0, j0, bi, bj)
        for spec_i in range(4):
            got = np.full_like(x, np.nan)
            for puts in out:
                (r0, r1), (c0, c1) = puts[spec_i][0]
                np.testing.assert_array_equal(puts[spec_i][1],
                                              x[r0:r1, c0:c1])
                got[r0:r1, c0:c1] = puts[spec_i][1]
            np.testing.assert_array_equal(got, x)
        got = _read(ctx, str(tmp_path), c_spec)[i0:i0 + bi, j0:j0 + bj]
        want = tile[:bi, :bj] if order == "R" else tile[:bj, :bi].T
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n,k", [(90, 70, 100), (32, 32, 32)])
def test_gemm_sharded_sharded_reads_match(pools, ctx, rng, tmp_path, m, n,
                                          k):
    """The per-rank read path (8 ranks, StrideInfo sub-accesses of each
    shard) against bof_tpu's forced sharded reads and whole-tile path, and
    the port's own two paths in a world of one rank bit for bit; ragged
    tails, and contiguous whole-tile accesses (32^3)."""
    import bof_tpu.parallel.mesh as meshmod
    from bof_tpu.parallel import gemm_sharded, make_mesh
    for order, ta, tb in (("R", "N", "N"), ("C", "T", "N"),
                          ("R", "N", "T")):
        tag = f"{order}{ta}{tb}"
        a, b, specs = _gemm_case(ctx, tmp_path, rng, m, n, k, order, ta, tb,
                                 tag=tag)
        A, B, C = _ref_arrays(ctx, str(tmp_path), specs)
        kw = dict(transa=ta, transb=tb, blk=32)
        meshmod._FORCE_SHARDED_READS = True
        try:
            gemm_sharded(A, B, C, mesh=make_mesh(WORLD), ctx=ctx, **kw)
        finally:
            meshmod._FORCE_SHARDED_READS = False
        ref = C.read_all()
        pools.get(WORLD).run(jobs.gemm, str(tmp_path), specs[0], specs[1],
                             specs[3], kw)
        got = _read(ctx, str(tmp_path), specs[3])
        want = _want(a, b, ta, tb).astype(np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("mode,tol", [("bfloat16", 2e-2), ("int8", 5e-2)])
def test_gemm_sharded_transfer_modes(pools, ctx, rng, tmp_path, mode, tol):
    """bf16/int8 shards: int8 shards quantize with the whole tile's scale
    (a max over the ranks), their int32 partials reduce-scatter exactly
    before one rescale; inside bof_tpu's band against float64, beside
    bof_tpu's single-process answer."""
    from bof_tpu.parallel import gemm_sharded, make_mesh
    ctx.config.transfer_dtype = mode
    try:
        for ta, beta in (("N", 0.0), ("T", 0.5)):
            m, n, k = 96, 64, 80
            c0 = rng.standard_normal((m, n)).astype(np.float32)
            a, b, specs = _gemm_case(ctx, tmp_path, rng, m, n, k, "R", ta,
                                     "N", tag=ta, c0=c0)
            A, B, C = _ref_arrays(ctx, str(tmp_path), specs)
            kw = dict(alpha=1.25, beta=beta, transa=ta, blk=32)
            gemm_sharded(A, B, C, mesh=make_mesh(WORLD), ctx=ctx, **kw)
            pools.get(WORLD).run(jobs.gemm, str(tmp_path), specs[0],
                                 specs[1], specs[3], kw,
                                 {"transfer_dtype": mode})
            got = _read(ctx, str(tmp_path), specs[3]).astype(np.float64)
            want = _want(a, b, ta, "N", 1.25, beta, c0)
            rel = np.abs(got - want).max() / np.abs(want).max()
            assert 1e-7 < rel < tol, (mode, ta, rel)
            ref = C.read_all().astype(np.float64)
            assert np.abs(got - ref).max() / np.abs(want).max() < 1e-5
    finally:
        ctx.config.transfer_dtype = "float32"


def test_gemm_sharded_float64(pools, ctx, rng, tmp_path):
    """float64 on the mesh: the port runs K1 'f64' a shard (gemm64(mesh=)
    and gemm_sharded alike) where bof_tpu slices (gemm64's mesh path; its
    native fp64 path needs x64, tests/test_parallel.py:538); both within
    bof_tpu's 1e-12 scaled bound of numpy's product."""
    from bof_tpu.ops.gemm64 import gemm64
    from bof_tpu.parallel import make_mesh
    dm, dk, dn = 35, 33, 40
    a = rng.standard_normal((dm, dk)) * 10.0 ** rng.uniform(-12, 12,
                                                             (dm, 1))
    b = rng.standard_normal((dk, dn))
    w = str(tmp_path)
    specs = [_write(ctx, os.path.join(w, nm), x) for nm, x in
             (("A", a), ("B", b), ("Cref", np.zeros((dm, dn))),
              ("Cport", np.zeros((dm, dn))))]
    A, B, C = _ref_arrays(ctx, w, specs)
    gemm64(A, B, C, blk=16, ctx=ctx, mesh=make_mesh(WORLD))
    want = a @ b
    scl = np.abs(a).max(1)[:, None] * np.abs(b).max(0)[None, :] * dk
    for fp64 in (True, False):
        pools.get(WORLD).run(jobs.gemm, w, specs[0], specs[1], specs[3],
                             {"blk": 16}, None, False, fp64)
        got = _read(ctx, w, specs[3])
        assert (np.abs(got - want) / scl).max() < 1e-12
    assert (np.abs(C.read_all() - want) / scl).max() < 1e-12


# ----------------------------------------------------- the data plane

def test_multi_process_data_plane(pools, ctx, rng, tmp_path):
    """tests/test_multiprocess.py:43 on 8 gloo ranks: every rank reads and
    writes only its shards of gemm's C, csrmm's C rows and the Lloyd
    labels in shared files, folds its one-pass U partials and all-reduces
    them; each result against bof_tpu's single-process 2x4 mesh run of
    the same program (the port's sums reduce in another order: fp32
    tolerances; rows and labels with no collective: bit for bit)."""
    import scipy.sparse as sps

    from bof_tpu.apps.eigensolver import (_apply_ata_one_pass_sharded,
                                          block_lanczos_svd)
    from bof_tpu.ops.gemm64 import gemm64
    from bof_tpu.parallel import (csrmm_sharded, gemm_sharded,
                                  lloyds_iter_ooc_sharded, make_mesh)
    from bof_tpu.sparse import CsrFlashMatrix
    w = str(tmp_path)

    def put(name, data):
        _write(ctx, os.path.join(w, name), data)
        return bof_tpu.map_array(os.path.join(w, name), data.shape,
                                 data.dtype, ctx=ctx)
    m, k, n = 90, 100, 70
    a_np = rng.standard_normal((m, k)).astype(np.float32)
    b_np = rng.standard_normal((k, n)).astype(np.float32)
    A, B = put("A.bin", a_np), put("B.bin", b_np)
    C_sp = put("C_sp.bin", np.zeros((m, n), np.float32))
    put("C_mp.bin", np.zeros((m, n), np.float32))
    sm, sk, sn = 200, 64, 24
    a_sp = sps.random(sm, sk, density=0.08, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(3))
    As = CsrFlashMatrix.from_scipy(a_sp, backing="file",
                                   path_prefix=os.path.join(w, "S"), ctx=ctx)
    SB = put("SB.bin", rng.standard_normal((sk, sn)).astype(np.float32))
    SC_sp = put("SC_sp.bin", np.zeros((sm, sn), np.float32))
    put("SC_mp.bin", np.zeros((sm, sn), np.float32))
    a64 = rng.standard_normal((35, 33)) * 10.0 ** rng.uniform(-12, 12,
                                                               (35, 1))
    b64 = rng.standard_normal((33, 40))
    A6, B6 = put("A64.bin", a64), put("B64.bin", b64)
    put("C64_mp.bin", np.zeros((35, 40)))
    KP = put("KP.bin", rng.standard_normal((165, 8)).astype(np.float32))
    KL_sp = put("KL_sp.bin", np.full(165, -1, np.int32))
    put("KL_mp.bin", np.full(165, -1, np.int32))
    v_op = np.random.default_rng(17).standard_normal((sk, 5)).astype(
        np.float32)

    mesh = make_mesh(WORLD)
    gemm_sharded(A, B, C_sp, blk=32, mesh=mesh, ctx=ctx)
    csrmm_sharded(As, SB, SC_sp, mesh=mesh, ctx=ctx)
    kc_sp, _, _ = lloyds_iter_ooc_sharded(
        KP, KP.read_block(0, 4, 0, 8).copy(), labels_out=KL_sp, mesh=mesh,
        blk_rows=64, ctx=ctx)
    u_sp = _apply_ata_one_pass_sharded(As, v_op, mesh, ctx)
    sigma_sp, V_sp = block_lanczos_svd(As, n_vals=3, max_kdim=24,
                                       n_restarts=4, seed=11,
                                       one_pass=True, mesh=mesh, ctx=ctx)

    out = pools.get(WORLD).run(jobs.data_plane, w, v_op)
    kc_mp, u_mp, sigma_mp, V_mp = out[0]
    for o in out[1:]:  # every rank holds the same replicated results
        for x, y in zip(o, out[0]):
            np.testing.assert_array_equal(x, y)

    def raw(name, dt):
        return np.fromfile(os.path.join(w, name), dt)
    got_c = raw("C_mp.bin", np.float32)
    np.testing.assert_allclose(got_c, raw("C_sp.bin", np.float32),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(
        got_c.reshape(m, n), (a_np.astype(np.float64) @ b_np).astype(
            np.float32), rtol=2e-4, atol=1e-3)
    got_s = raw("SC_mp.bin", np.float32).reshape(sm, sn)
    np.testing.assert_allclose(got_s, raw("SC_sp.bin", np.float32).reshape(
        sm, sn), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got_s, a_sp @ SB.read_all(), rtol=2e-4,
                               atol=1e-4)
    got_l = raw("KL_mp.bin", np.int32)
    assert (got_l >= 0).all()
    np.testing.assert_array_equal(got_l, raw("KL_sp.bin", np.int32))
    np.testing.assert_allclose(kc_mp, kc_sp, rtol=1e-5, atol=1e-5)
    got_64 = raw("C64_mp.bin", np.float64).reshape(35, 40)
    scl = np.abs(a64).max(1)[:, None] * np.abs(b64).max(0)[None, :] * 33
    assert (np.abs(got_64 - a64 @ b64) / scl).max() < 1e-12
    want_u = a_sp.T.astype(np.float64) @ (a_sp.astype(np.float64) @ v_op)
    np.testing.assert_allclose(u_mp, want_u, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(u_mp, u_sp, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(sigma_mp, sigma_sp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        sigma_mp, np.linalg.svd(a_sp.toarray(), compute_uv=False)[:3],
        rtol=1e-3)
    np.testing.assert_allclose(np.abs(np.sum(V_mp * V_sp, axis=0)), 1.0,
                               atol=1e-3)


@pytest.mark.parametrize("what", ["gemm", "csrmm", "kmeans"])
def test_sharded_writes_with_o_direct(pools, rng, tmp_path, what):
    """O_DIRECT stores: the 8 ranks' shards of C (gemm: 8-column runs of
    a 800-byte row; csrmm: 40-byte rows; Lloyd: 4-byte labels) share
    512-byte sectors, which an O_DIRECT write reads, modifies and writes
    back; each rank writes its shards through a buffered store of the
    same file (`shard_writer`), so no update is lost."""
    import scipy.sparse as sps
    w = str(tmp_path)
    if what == "gemm":
        a, b = (rng.standard_normal((200, 200)).astype(np.float32)
                for _ in range(2))
        for nm, x in (("A", a), ("B", b), ("C", np.zeros_like(a))):
            x.tofile(os.path.join(w, nm))
        want = a.astype(np.float64) @ b
    elif what == "csrmm":
        s = sps.random(3000, 200, density=0.02, format="csr",
                       dtype=np.float32, random_state=np.random.RandomState(1))
        for ext, x in ((".off", s.indptr.astype(np.int64)),
                       (".col", s.indices.astype(np.int64)),
                       (".csr", s.data)):
            x.tofile(os.path.join(w, "S" + ext))
        sb = rng.standard_normal((200, 10)).astype(np.float32)
        sb.tofile(os.path.join(w, "SB"))
        np.zeros((3000, 10), np.float32).tofile(os.path.join(w, "SC"))
        want = s @ sb
    else:
        pts = rng.standard_normal((3001, 8)).astype(np.float32)
        pts.tofile(os.path.join(w, "P"))
        np.full(3001, -1, np.int32).tofile(os.path.join(w, "L"))
        c = pts[:4].astype(np.float64)
        want = ((pts[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)
    pools.get(WORLD).run(jobs.o_direct_writes, w, what)
    out, dt = {"gemm": ("C", np.float32), "csrmm": ("SC", np.float32),
               "kmeans": ("L", np.int32)}[what]
    got = np.fromfile(os.path.join(w, out), dt)[:want.size].reshape(
        want.shape)
    if what == "kmeans":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


def test_gemm_sharded_tile_major_needs_one_rank(pools, rng, tmp_path):
    """Tile-major operands need whole-tile reads: several ranks raise
    ValueError (as bof_tpu's multi-host branch does); one rank computes
    (`test_gemm_sharded_tile_major_on_one_rank`)."""
    a = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal((48, 40)).astype(np.float32)
    out = pools.get(WORLD).run(jobs.gemm_tiled, str(tmp_path), a, b)
    assert all("whole-tile reads" in o for o in out), out


# ------------------------------------------------------ a world of one

def test_make_mesh_of_one_rank(pools, tmp_path):
    """A world of one rank: a 1 x 1 mesh (bof_tpu's make_mesh(1))."""
    from bof_tpu.parallel import make_mesh as ref_make_mesh
    assert tuple(ref_make_mesh(1).devices.shape) == (1, 1)
    (shape, names, coord, err), = pools.get(1).run(jobs.mesh_info,
                                                   str(tmp_path))
    assert shape == (1, 1) and names == ("x", "y") and coord == (0, 0)
    assert "need 2 devices" in err


@pytest.mark.parametrize("m,n,k", [(90, 70, 100), (32, 32, 32)])
def test_gemm_sharded_one_rank_read_paths_match(pools, ctx, rng, tmp_path,
                                                m, n, k):
    """In a world of one rank, the whole-tile path and the per-rank read
    path (forced) give the same bits, beside bof_tpu's two paths (which it
    holds byte-identical, tests/test_parallel.py:407)."""
    import bof_tpu.parallel.mesh as meshmod
    from bof_tpu.parallel import gemm_sharded, make_mesh
    for order, ta, tb in (("R", "N", "N"), ("C", "T", "N"),
                          ("R", "N", "T")):
        tag = f"{order}{ta}{tb}"
        a, b, specs = _gemm_case(ctx, tmp_path, rng, m, n, k, order, ta, tb,
                                 tag=tag)
        A, B, C = _ref_arrays(ctx, str(tmp_path), specs)
        kw = dict(transa=ta, transb=tb, blk=32)
        gemm_sharded(A, B, C, mesh=make_mesh(1), ctx=ctx, **kw)
        ref = C.read_all()
        one = []
        for forced in (False, True):
            pools.get(1).run(jobs.gemm, str(tmp_path), specs[0], specs[1],
                             specs[3], kw, None, forced)
            one.append(_read(ctx, str(tmp_path), specs[3]))
        np.testing.assert_array_equal(one[0], one[1])
        want = _want(a, b, ta, tb).astype(np.float32)
        np.testing.assert_allclose(one[0], want, rtol=2e-4, atol=1e-3)
        np.testing.assert_allclose(one[0], ref, rtol=2e-4, atol=1e-3)


# ------------------------------------------------------ K1 's8' int32 out

@pytest.mark.parametrize("a_km", [False, True])
@pytest.mark.parametrize("b_nk", [False, True])
@pytest.mark.parametrize("c_nm", [False, True])
def test_s8_int32_output_plain_is_the_exact_product(rng, a_km, b_nk, c_nm):
    """K1 's8' into an int32 C (the sharded int8 step's partial): C += the
    exact integer product, numpy's int64 product bit for bit, past the K
    (1,040) where fp32 partials would drop bits; added to what C holds;
    alpha other than 1 raises."""
    from bof_tpu_torch.ops.matmul_cuda import accum_matmul, k1_variant
    m, n, k = 33, 20, 3000
    # same-signed large values: sums near 127^2 * K
    a = rng.integers(100, 128, (k, m) if a_km else (m, k), dtype=np.int8)
    b = rng.integers(100, 128, (n, k) if b_nk else (k, n), dtype=np.int8)
    a[:, :3] *= -1
    c0 = rng.integers(-1000, 1000, (n, m) if c_nm else (m, n),
                      dtype=np.int32)
    c = torch.from_numpy(c0.copy())
    accum_matmul(c, torch.from_numpy(a), torch.from_numpy(b), 1.0,
                 a_km=a_km, b_nk=b_nk, c_nm=c_nm)
    prod = ((a.T if a_km else a).astype(np.int64)
            @ (b.T if b_nk else b).astype(np.int64))
    want = c0.astype(np.int64) + (prod.T if c_nm else prod)
    assert np.abs(prod).max() > 1 << 24  # past fp32's exact integers
    np.testing.assert_array_equal(c.numpy(), want)
    assert k1_variant("highest", dtype=torch.int8,
                      c_dtype=torch.int32) == "s8_i32"
    with pytest.raises(ValueError, match="alpha 1"):
        accum_matmul(c, torch.from_numpy(a), torch.from_numpy(b), 0.5,
                     a_km=a_km, b_nk=b_nk, c_nm=c_nm)


def test_gemm_sharded_tile_major_on_one_rank(pools, rng, tmp_path):
    """A world of one rank reads whole tiles, so tile-major operands work
    (bof_tpu's single process takes them too)."""
    a = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal((48, 40)).astype(np.float32)
    got, = pools.get(1).run(jobs.gemm_tiled, str(tmp_path), a, b)
    np.testing.assert_allclose(got, a.astype(np.float64) @ b, rtol=2e-4,
                               atol=1e-4)
