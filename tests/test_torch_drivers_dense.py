"""The port's dense and k-means CLI drivers on the CPU, as bof_tpu's
tests/test_drivers.py runs bof_tpu's (its cases at :28, :120, :136, :142,
:148, :168, :358 and :384), with `--device cpu`; plus tile-major files
written by bof_tpu read by the port bit for bit, and the k-means driver
against bof_tpu's fit on the same file.

The drivers run in this process through their `main(argv)`.
"""
import importlib
import os

import numpy as np
import pytest

import bof_tpu
import bof_tpu_torch
from bof_tpu.ops.kmeans import kmeans_fit as ref_kmeans_fit

# drivers without the shared parser (no --device or --scratch)
_PLAIN = {"dense_create"}


def run_driver(mod, *args, scratch=None):
    argv = [str(a) for a in args]
    if mod not in _PLAIN:
        argv += ["--device", "cpu"]
        if scratch is not None:
            argv += ["--scratch", scratch]
    return importlib.import_module(f"bof_tpu_torch.drivers.{mod}").main(argv)


@pytest.fixture
def scratch(tmp_path):
    d = tmp_path / "scratch"
    d.mkdir()
    return str(d)


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-4),
                                        ("float64", 1e-12)])
def test_dense_create_and_gemm_driver(tmp_path, scratch, capsys, dtype, rtol):
    m = n = k = 96
    dt = np.dtype(dtype)
    a, b, c = (str(tmp_path / x) for x in "abc")
    run_driver("dense_create", a, m, k, "--fill", "random", "--dtype", dtype)
    run_driver("dense_create", b, k, n, "--fill", "random", "--seed", 1,
               "--dtype", dtype)
    run_driver("gemm", a, b, c, m, n, k, "--create-c", "--blk", 32,
               "--dtype", dtype, scratch=scratch)
    assert "checksum" in capsys.readouterr().out
    got = np.fromfile(c, dt).reshape(m, n)
    a_np = np.fromfile(a, dt).reshape(m, k)
    b_np = np.fromfile(b, dt).reshape(k, n)
    want = a_np.astype(np.float64) @ b_np
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    # the files are bof_tpu's dense_create's, byte for byte
    ref = str(tmp_path / "ref_a")
    from bof_tpu.drivers import dense_create as ref_dense_create
    ref_dense_create.main([ref, str(m), str(k), "--fill", "random",
                           "--dtype", dtype])
    assert open(ref, "rb").read() == open(a, "rb").read()
    # journaled run through the CLI: completes and removes its journal
    jp = str(tmp_path / "journal.txt")
    run_driver("gemm", a, b, c, m, n, k, "--blk", 32, "--dtype", dtype,
               "--resume-journal", jp, scratch=scratch)
    assert not os.path.exists(jp)
    np.testing.assert_array_equal(np.fromfile(c, dt).reshape(m, n), got)


def test_kmeans_driver(tmp_path, scratch, capsys):
    """fp32 and fp64 points through the CLI, with --labels-out and
    --state; the fp32 fit within 1e-4 of bof_tpu's on the same file."""
    n, d, k = 1000, 8, 4
    pts = str(tmp_path / "p")
    data = np.random.default_rng(1).standard_normal((n, d)).astype(
        np.float32)
    data.tofile(pts)
    labels = str(tmp_path / "labels")
    state = str(tmp_path / "state.npz")
    centers, inertia = run_driver("kmeans", pts, n, d, k, "--iters", 2,
                                  "--labels-out", labels, "--state", state,
                                  scratch=scratch)
    assert "inertia" in capsys.readouterr().out
    assert not os.path.exists(state), "a finished fit consumes its state"
    d2 = ((data[:, None, :].astype(np.float64)
           - centers[None].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(np.fromfile(labels, np.int32),
                                  d2.argmin(1))
    ctx = bof_tpu.FlashContext(bof_tpu.FlashConfig(
        scratch_dir=str(tmp_path / "ref")))
    try:
        P = bof_tpu.map_array(pts, (n, d), np.float32, ctx=ctx)
        L = bof_tpu.mem_array((n,), np.int32, ctx=ctx)
        # with labels_out the inertia is the final assignment pass's
        want_c, want_i = ref_kmeans_fit(P, k, n_iters=2, seed=0,
                                        labels_out=L, ctx=ctx)
    finally:
        ctx.destroy()
    np.testing.assert_allclose(centers, want_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(inertia, want_i, rtol=1e-4)
    pts64 = str(tmp_path / "p64")
    np.random.default_rng(1).standard_normal((n, d)).tofile(pts64)
    c64, _ = run_driver("kmeans", pts64, n, d, k, "--iters", 2, "--dtype",
                        "float64", scratch=scratch)
    assert c64.dtype == np.float64
    assert "inertia" in capsys.readouterr().out
    # --sharded on a world of one rank: bof_tpu's mesh fit on make_mesh(1)
    from bof_tpu.parallel import kmeans_fit_sharded, make_mesh
    from torch_dist_pool import one_rank_world
    with one_rank_world():
        c_sh, i_sh = run_driver("kmeans", pts, n, d, k, "--iters", 2,
                                "--sharded", scratch=scratch)
    ctx = bof_tpu.FlashContext(bof_tpu.FlashConfig(
        scratch_dir=str(tmp_path / "ref")))
    try:
        P = bof_tpu.map_array(pts, (n, d), np.float32, ctx=ctx)
        want_c, want_i = kmeans_fit_sharded(P, k, n_iters=2, seed=0,
                                            mesh=make_mesh(1), ctx=ctx)
    finally:
        ctx.destroy()
    np.testing.assert_allclose(c_sh, want_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(i_sh, want_i, rtol=1e-4)


def test_kmeans_in_mem_baseline(tmp_path, capsys):
    pts = str(tmp_path / "p")
    np.random.default_rng(8).standard_normal((500, 4)).astype(
        np.float32).tofile(pts)
    _, inertia = run_driver("kmeans", pts, 500, 4, 3, "--iters", 2,
                            "--in-mem")
    assert f"inertia {inertia}" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["native", "python"])
def test_file_handle_test_driver(scratch, capsys, backend):
    rc = run_driver("file_handle_test", "--trials", 60, "--elems", 1 << 16,
                    "--io-backend", backend, scratch=scratch)
    assert rc == 0
    assert "PASS" in capsys.readouterr().out


def test_gemm_run_harness(scratch, capsys):
    rc = run_driver("gemm_run", "--m", 96, "--n", 64, "--k", 80, "--blk", 32,
                    scratch=scratch)
    assert rc == 0
    assert "ALL PASS" in capsys.readouterr().out


def test_gemm_run_harness_fp64_ld(scratch, capsys):
    """All 8 configs on float64 with ld-padded operand files at bof_tpu's
    1e-12, on bof_tpu's command line (its --fp64-device is accepted)."""
    rc = run_driver("gemm_run", "--m", 48, "--n", 40, "--k", 56, "--blk", 16,
                    "--dtype", "float64", "--fp64-device", "sliced",
                    "--ld-pad", 5, scratch=scratch)
    assert rc == 0
    out = capsys.readouterr().out
    assert "ALL PASS" in out and out.count("OK ") == 8


def test_in_mem_and_mmap_gemm_drivers(tmp_path, scratch):
    m = n = k = 64
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    run_driver("dense_create", a, m, k, "--seed", 2)
    run_driver("dense_create", b, k, n, "--seed", 3)
    a_np = np.fromfile(a, np.float32).reshape(m, k)
    b_np = np.fromfile(b, np.float32).reshape(k, n)
    want = a_np @ b_np
    c1 = str(tmp_path / "c1")
    np.zeros((m, n), np.float32).tofile(c1)
    run_driver("in_mem_gemm", a, b, c1, m, n, k)
    np.testing.assert_allclose(np.fromfile(c1, np.float32).reshape(m, n),
                               want, rtol=2e-4, atol=1e-4)
    c2 = str(tmp_path / "c2")
    np.zeros((m, n), np.float32).tofile(c2)
    run_driver("mmap_gemm", a, b, c2, m, n, k, "--blk", 32)
    np.testing.assert_allclose(np.fromfile(c2, np.float32).reshape(m, n),
                               want, rtol=2e-4, atol=1e-4)
    # fp64 twins: a float64 matmul and host dgemm, against numpy
    a64, b64 = str(tmp_path / "a64"), str(tmp_path / "b64")
    r = np.random.default_rng(4)
    an, bn = r.standard_normal((m, k)), r.standard_normal((k, n))
    an.tofile(a64)
    bn.tofile(b64)
    c3, c4 = str(tmp_path / "c3"), str(tmp_path / "c4")
    np.zeros((m, n)).tofile(c3)
    np.zeros((m, n)).tofile(c4)
    run_driver("in_mem_gemm", a64, b64, c3, m, n, k, "--dtype", "float64")
    np.testing.assert_allclose(np.fromfile(c3).reshape(m, n), an @ bn,
                               rtol=1e-13, atol=1e-12)
    run_driver("mmap_gemm", a64, b64, c4, m, n, k, "--blk", 32,
               "--dtype", "float64")
    np.testing.assert_allclose(np.fromfile(c4).reshape(m, n), an @ bn,
                               rtol=1e-13, atol=1e-12)


def test_repack_and_tiled_gemm_driver(tmp_path, scratch, capsys):
    """repack converts flat<->tiled; gemm --tile matches the flat run."""
    m, n, k, ts = 96, 80, 88, 32
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    at, bt, ct = (str(tmp_path / x) for x in ("at", "bt", "ct"))
    run_driver("dense_create", a, m, k, "--fill", "random")
    run_driver("dense_create", b, k, n, "--fill", "random", "--seed", 1)
    assert run_driver("repack", a, at, m, k, "--tile", ts, "--verify",
                      scratch=scratch) == 0
    assert "OK" in capsys.readouterr().out
    run_driver("repack", b, bt, k, n, "--tile", ts, scratch=scratch)
    run_driver("gemm", at, bt, ct, m, n, k, "--tile", ts, "--create-c",
               scratch=scratch)
    assert "checksum" in capsys.readouterr().out
    cf = str(tmp_path / "cf")
    run_driver("repack", cf, ct, m, n, "--tile", ts, "--unpack",
               scratch=scratch)
    got = np.fromfile(cf, np.float32).reshape(m, n)
    a_np = np.fromfile(a, np.float32).reshape(m, k)
    b_np = np.fromfile(b, np.float32).reshape(k, n)
    np.testing.assert_allclose(got, a_np @ b_np, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,order", [("float32", "R"),
                                         ("float64", "C")])
def test_reference_tiled_files_read_bit_for_bit(tmp_path, dtype, order):
    """Tile-major files written by bof_tpu.repack are the port's repack's
    bytes, and the port's gemm over them gives the bits of its gemm over
    the flat files (the same tiles, summed in the same order)."""
    m, n, k, ts = 40, 36, 44, 16
    dt = np.dtype(dtype)
    rng = np.random.default_rng(10)
    flat = {"a": rng.standard_normal((m, k)).astype(dt),
            "b": rng.standard_normal((k, n)).astype(dt)}
    shapes = {"a": (m, k), "b": (k, n)}
    for pkg, tag in ((bof_tpu, "ref"), (bof_tpu_torch, "port")):
        cfg = pkg.FlashConfig(scratch_dir=str(tmp_path / tag))
        if pkg is bof_tpu_torch:
            cfg.device = "cpu"
        ctx = pkg.FlashContext(cfg)
        try:
            for nm, data in flat.items():
                F = pkg.map_array(str(tmp_path / f"{nm}.flat"), shapes[nm],
                                  dt, order, create=tag == "ref", ctx=ctx)
                if tag == "ref":
                    F.write_all(data)
                T = pkg.map_tiled_array(str(tmp_path / f"{nm}.{tag}"),
                                        shapes[nm], dt, order, tile=ts,
                                        create=True, ctx=ctx)
                pkg.repack(F, T)
        finally:
            ctx.destroy()
    for nm in flat:
        assert (open(tmp_path / f"{nm}.ref", "rb").read()
                == open(tmp_path / f"{nm}.port", "rb").read())
    ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
        device="cpu", scratch_dir=str(tmp_path / "g")))
    try:
        outs = []
        for kind in ("tiled", "flat"):
            if kind == "tiled":
                A, B = (bof_tpu_torch.map_tiled_array(
                    str(tmp_path / f"{nm}.ref"), shapes[nm], dt, order,
                    tile=ts, ctx=ctx) for nm in "ab")
            else:
                A, B = (bof_tpu_torch.map_array(
                    str(tmp_path / f"{nm}.flat"), shapes[nm], dt, order,
                    ctx=ctx) for nm in "ab")
            C = bof_tpu_torch.mem_array((m, n), dt, order, ctx=ctx)
            bof_tpu_torch.gemm(A, B, C, alpha=0.5, blk=ts, ctx=ctx)
            outs.append(C.read_all())
    finally:
        ctx.destroy()
    np.testing.assert_array_equal(outs[0], outs[1])
    want = 0.5 * flat["a"].astype(np.float64) @ flat["b"]
    np.testing.assert_allclose(outs[0], want, rtol=2e-4 if dtype ==
                               "float32" else 1e-12, atol=1e-4)


def test_gemm_driver_lda(tmp_path, scratch):
    """ld-padded sub-matrices through the CLI (--lda/--ldb/--ldc)."""
    m, n, k = 48, 40, 56
    lda, ldb, ldc = 64, 72, 50
    rng = np.random.default_rng(9)
    a_full = rng.standard_normal((m, lda)).astype(np.float32)
    b_full = rng.standard_normal((k, ldb)).astype(np.float32)
    c_full = np.zeros((m, ldc), np.float32)
    a, b, c = (str(tmp_path / x) for x in "abc")
    a_full.tofile(a)
    b_full.tofile(b)
    c_full.tofile(c)
    run_driver("gemm", a, b, c, m, n, k, "--blk", 32, "--lda", lda, "--ldb",
               ldb, "--ldc", ldc, scratch=scratch)
    got = np.fromfile(c, np.float32).reshape(m, ldc)
    want = a_full[:, :k] @ b_full[:, :n]
    np.testing.assert_allclose(got[:, :n], want, rtol=2e-4, atol=1e-4)
    # bytes beyond the logical width are the pad, untouched by the kernel
    np.testing.assert_array_equal(got[:, n:], 0.0)
