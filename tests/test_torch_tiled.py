"""The port's tile-major arrays (`bof_tpu_torch/core/tiled_array.py`) and
fp32 `gemm`, `csrmm` and `gemm_sharded` on tile-major operands, against
bof_tpu, case for case after tests/test_tiled.py: the same repacks,
windows and kernel calls on both packages; data must match bit for bit
where it is moved and within bof_tpu's tolerance where it is computed
(fp32: rtol 2e-4 of the reference's own test against float64, and the
port against bof_tpu at rtol 2e-4)."""
import os

import numpy as np
import pytest
import scipy.sparse as sps

from torch_pair import BOTH, PORT, REF


@pytest.fixture
def contexts(tmp_path):
    ctxs = {pk.name: pk.context(tmp_path / f"{pk.name}_scratch")
            for pk in BOTH}
    yield ctxs
    for c in ctxs.values():
        c.destroy()


def mem_tiled(pk, shape, dtype=np.float32, order="R", tile=16, ctx=None):
    m, n = shape
    nbytes = (-(-m // tile)) * (-(-n // tile)) * tile * tile \
        * np.dtype(dtype).itemsize
    return pk.bt.TiledFlashArray(pk.mod("io.store").MemStore(nbytes), shape,
                                 dtype, order, tile=tile, ctx=ctx)


def on_both(contexts, body):
    return tuple(body(pk, contexts[pk.name]) for pk in BOTH)


@pytest.mark.parametrize("order", ["R", "C"])
@pytest.mark.parametrize("shape", [(32, 48), (33, 47), (16, 16), (7, 70)])
def test_repack_roundtrip(contexts, order, shape):
    data = np.random.default_rng(0).standard_normal(shape).astype(np.float32)

    def body(pk, ctx):
        ta = pk.mod("core.tiled_array")
        flat = pk.bt.mem_array(shape, np.float32, order, data=data, ctx=ctx)
        tiled = mem_tiled(pk, shape, order=order, tile=16, ctx=ctx)
        ta.repack(flat, tiled)
        back = pk.bt.mem_array(shape, np.float32, order, ctx=ctx)
        ta.unpack(tiled, back)
        raw = tiled.store.read_sync(0, pk.mod("io.stride").StrideInfo
                                    .contiguous(tiled.store.size()))
        return tiled.read_all(), back.read_all(), raw.copy()
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port[0], data)
    np.testing.assert_array_equal(port[1], data)
    np.testing.assert_array_equal(port[2], ref[2])  # the tile-major bytes


@pytest.mark.parametrize("order", ["R", "C"])
def test_general_windows(contexts, order):
    """Random unaligned windows across tile boundaries, and a
    read-modify-write of one, against a numpy model."""
    shape = (45, 37)

    def body(pk, ctx):
        rng = np.random.default_rng(0)
        data = rng.standard_normal(shape).astype(np.float32)
        tiled = mem_tiled(pk, shape, order=order, tile=16, ctx=ctx)
        tiled.write_block(0, data)
        for _ in range(12):
            r0 = int(rng.integers(0, shape[0] - 1))
            c0 = int(rng.integers(0, shape[1] - 1))
            nr = int(rng.integers(1, shape[0] - r0 + 1))
            nc = int(rng.integers(1, shape[1] - c0 + 1))
            np.testing.assert_array_equal(tiled.read_block(r0, nr, c0, nc),
                                          data[r0:r0 + nr, c0:c0 + nc])
        patch = rng.standard_normal((20, 21)).astype(np.float32)
        tiled.write_block(9, patch, 5)
        data[9:29, 5:26] = patch
        np.testing.assert_array_equal(tiled.read_all(), data)
        return tiled.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port, ref)


def test_access_contract(contexts):
    """Unaligned or tile-spanning accesses raise ValueError, a tile is one
    run, and memmap/ravel views raise TypeError, in both packages."""
    def body(pk, ctx):
        tiled = mem_tiled(pk, (32, 32), tile=16, ctx=ctx)
        raised = []
        for call in (lambda: tiled.block_access(8, 16, 0, 16),
                     lambda: tiled.block_access(0, 32, 0, 16),
                     tiled.as_memmap, tiled.ravel_view):
            with pytest.raises((ValueError, TypeError)) as e:
                call()
            raised.append(type(e.value))
        off, sinfo = tiled.block_access(16, 16, 16, 16)
        return raised, (off, sinfo.n_strides, sinfo.len_per_stride)
    ref, port = on_both(contexts, body)
    assert port == ref
    assert port[0] == [ValueError, ValueError, TypeError, TypeError]
    assert port[1][1:] == (1, 16 * 16 * 4)


def rel_err(got, want):
    return np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("order,ta,tb,beta", [
    ("R", "N", "N", 0.0),
    ("R", "N", "N", 0.7),
    ("C", "N", "N", 0.0),
    ("R", "T", "N", 0.0),
    ("R", "N", "T", 0.5),
    ("C", "T", "T", 0.0),
])
def test_gemm_tiled_operands(contexts, order, ta, tb, beta):
    """fp32 gemm over tile-major A, B and C with ragged tails: within
    2e-4 of float64, and the port within 2e-4 of bof_tpu."""
    m, n, k, blk = 40, 36, 44, 16
    rng = np.random.default_rng(0)
    a_shape = (k, m) if ta == "T" else (m, k)
    b_shape = (n, k) if tb == "T" else (k, n)
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = rng.standard_normal(b_shape).astype(np.float32)
    c0 = rng.standard_normal((m, n)).astype(np.float32)

    def body(pk, ctx):
        A, B, C = (mem_tiled(pk, s, order=order, tile=blk, ctx=ctx)
                   for s in (a_shape, b_shape, (m, n)))
        for arr, x in ((A, a), (B, b), (C, c0)):
            arr.write_block(0, x)
        pk.mod("ops.gemm").gemm(A, B, C, alpha=1.25, beta=beta, transa=ta,
                                transb=tb, blk=blk, ctx=ctx)
        return C.read_all()
    ref, port = on_both(contexts, body)
    opa = (a.T if ta == "T" else a).astype(np.float64)
    opb = (b.T if tb == "T" else b).astype(np.float64)
    want = 1.25 * (opa @ opb) + beta * c0.astype(np.float64)
    assert rel_err(port, want) < 2e-4
    np.testing.assert_allclose(port, ref, rtol=2e-4, atol=2e-4 * np.abs(
        want).max())


def test_gemm_mixed_flat_tiled(contexts):
    m, n, k, blk = 33, 18, 26, 16
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)

    def body(pk, ctx):
        A = mem_tiled(pk, (m, k), tile=blk, ctx=ctx)
        A.write_block(0, a)
        B = pk.bt.mem_array((k, n), np.float32, data=b, ctx=ctx)
        C = pk.bt.mem_array((m, n), np.float32, ctx=ctx)
        pk.mod("ops.gemm").gemm(A, B, C, blk=blk, ctx=ctx)
        return C.read_all()
    ref, port = on_both(contexts, body)
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert rel_err(port, want) < 2e-4
    np.testing.assert_allclose(port, ref, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def test_gemm_blk_mismatch_raises(contexts):
    def body(pk, ctx):
        A = mem_tiled(pk, (32, 32), tile=16, ctx=ctx)
        B = pk.bt.mem_array((32, 32), np.float32, ctx=ctx)
        C = pk.bt.mem_array((32, 32), np.float32, ctx=ctx)
        with pytest.raises(ValueError, match="tile-major") as e:
            pk.mod("ops.gemm").gemm(A, B, C, blk=32, ctx=ctx)
        return str(e.value)
    ref, port = on_both(contexts, body)
    assert port == ref


def test_map_tiled_array_file(contexts, tmp_path):
    """File-backed tiled arrays: the padded grid's size, and persistence
    through the store, with the same file bytes in both packages."""
    shape = (45, 37)
    data = np.random.default_rng(0).standard_normal(shape).astype(np.float32)

    def body(pk, ctx):
        path = str(tmp_path / f"{pk.name}_tiled.bin")
        T = pk.bt.map_tiled_array(path, shape, np.float32, tile=16,
                                  create=True, ctx=ctx)
        T.write_block(0, data)
        T.store.flush()
        T2 = pk.bt.map_tiled_array(path, shape, np.float32, tile=16,
                                   ctx=ctx)
        return os.path.getsize(path), T2.read_all(), np.fromfile(path,
                                                                 np.uint8)
    ref, port = on_both(contexts, body)
    assert port[0] == ref[0] == 3 * 3 * 16 * 16 * 4
    np.testing.assert_array_equal(port[1], data)
    np.testing.assert_array_equal(port[2], ref[2])


def csrmm_tiled(contexts, cfg, m, k, n, ts, density, seed, alpha, beta,
                transa="N"):
    """csrmm with tile-major B and C under `cfg` on both packages: within
    rtol 1e-4 / atol 1e-4 of scipy (the reference's gate) and of
    bof_tpu."""
    a_sp = sps.random(m, k, density=density, format="csr", dtype=np.float32,
                      random_state=seed)
    rng = np.random.default_rng(0)
    b_rows, c_rows = (m, k) if transa == "T" else (k, m)
    b_np = rng.standard_normal((b_rows, n)).astype(np.float32)
    c_np = (np.zeros((c_rows, n), np.float32) if beta == 0.0 else
            rng.standard_normal((c_rows, n)).astype(np.float32))

    def body(pk, ctx):
        for key, val in cfg.items():
            setattr(ctx.config, key, val)
        A = pk.bt.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        B = mem_tiled(pk, (b_rows, n), tile=ts, ctx=ctx)
        C = mem_tiled(pk, (c_rows, n), tile=ts, ctx=ctx)
        B.write_block(0, b_np)
        C.write_block(0, c_np)
        pk.bt.csrmm(A, B, C, alpha=alpha, beta=beta, transa=transa, ctx=ctx)
        return C.read_all()
    ref, port = on_both(contexts, body)
    opa = a_sp.T if transa == "T" else a_sp
    want = alpha * (opa @ b_np) + beta * c_np
    np.testing.assert_allclose(port, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["device", "host"])
def test_csrmm_tiled_dense_operands(contexts, mode):
    """csrmm over tile-major B and C: the adaptive row blocks go through
    the general-window tile paths."""
    csrmm_tiled(contexts, dict(max_nnzs=2048, csrmm_cblk_size=32,
                               sparse_compute=mode),
                300, 200, 70, 64, 0.03, 3, 1.5, 0.5)


def test_csrmm_tiled_k_split(contexts):
    """K-range splitting accumulates into tiled C (tile RMW writes under
    the range barrier)."""
    csrmm_tiled(contexts, dict(max_nnzs=1024, csrmm_cblk_size=16,
                               hbm_budget=3 * 4096 * 16 * 4),
                150, 10_000, 24, 64, 0.003, 4, 1.25, 0.5)


def test_csrmm_trans_tiled(contexts):
    """'T' streaming reads tiled B and writes tiled C by general windows."""
    csrmm_tiled(contexts, dict(sparse_compute="host"), 200, 150, 40, 64,
                0.03, 5, 1.0, 0.0, transa="T")


def test_gemm_sharded_tiled_operands(contexts):
    """gemm_sharded over tile-major operands (tile == blk) on bof_tpu's
    8-device CPU mesh and on the port's world of one gloo rank (the port
    takes tile-major operands in a world of one rank only; several ranks
    raise, as bof_tpu's multi-host branch does): the same C within 2e-4,
    and a mismatched tile raises the same ValueError."""
    import jax
    from torch_dist_pool import one_rank_world
    if len(jax.devices()) < 8:
        pytest.fail("bof_tpu's 8-device CPU mesh is missing "
                    "(tests/conftest.py sets it up)")
    m, n, k, blk = 96, 80, 112, 32
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((m, k)).astype(np.float32)
    b_np = rng.standard_normal((k, n)).astype(np.float32)

    def body(pk, ctx, mesh):
        A, B, C = (mem_tiled(pk, s, tile=blk, ctx=ctx)
                   for s in ((m, k), (k, n), (m, n)))
        A.write_block(0, a_np)
        B.write_block(0, b_np)
        gemm_sharded = pk.mod("parallel").gemm_sharded
        gemm_sharded(A, B, C, blk=blk, mesh=mesh, ctx=ctx)
        with pytest.raises(ValueError, match="tile-major") as e:
            gemm_sharded(A, B, C, blk=16, mesh=mesh, ctx=ctx)
        return C.read_all(), type(e.value)

    ref = body(REF, contexts[REF.name], REF.mod("parallel").make_mesh(8))
    with one_rank_world() as mesh:
        port = body(PORT, contexts[PORT.name], mesh)
    want = (a_np.astype(np.float64) @ b_np.astype(np.float64)).astype(
        np.float32)
    np.testing.assert_allclose(port[0], want, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(port[0], ref[0], rtol=2e-4, atol=1e-4)
    assert port[1] is ref[1]


def test_tiled_partial_window_write_rejected(contexts):
    """A storage write of a partial window that is not the tile's whole
    logical extent raises and leaves the tile untouched; the grid-edge
    tail is legal."""
    rng = np.random.default_rng(0)
    want = rng.standard_normal((100, 40)).astype(np.float32)
    tail = rng.standard_normal((36, 40)).astype(np.float32)

    def body(pk, ctx):
        T = mem_tiled(pk, (100, 40), tile=64, ctx=ctx)
        T.write_all(want)
        T.write_block_storage(64, 0, 36, 40, tail)
        after_tail = T.read_all()
        with pytest.raises(ValueError, match="full logical extent") as e:
            T.write_block_storage(0, 0, 30, 40,
                                  np.zeros((30, 40), np.float32))
        return after_tail, T.read_all(), str(e.value)
    ref, port = on_both(contexts, body)
    expect = want.copy()
    expect[64:] = tail
    np.testing.assert_array_equal(port[0], expect)
    np.testing.assert_array_equal(port[1], expect)
    assert port[2] == ref[2]
