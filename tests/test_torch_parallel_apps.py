"""The port's applications on a mesh, and the drivers' --sharded, against
bof_tpu's, on gloo ranks.

Every application case of tests/test_parallel.py (xml_rank on its fused
and composition paths, block_lanczos_svd, topic_model, each with `mesh=`)
runs through both packages on the same seeded matrices: bof_tpu's in this
process on the virtual CPU mesh of tests/conftest.py (`make_mesh(4)`,
2x2), the port's on a world of 4 gloo ranks (tests/torch_dist_pool.py)
over CSR files, its scratch panels shared by the ranks.  Each driver's
--sharded runs on 2 gloo ranks, as torchrun would start it.  Tolerances:
XML scores by tests/test_parallel.py's top-k check (rtol 2e-4, atol
1e-4); singular values rtol 1e-4 against bof_tpu and 1e-3 against scipy;
topic labels equal to bof_tpu's on all but 1 % of the documents, the
topic-word matrix rtol 1e-4 (atol 1e-6) where they are all equal; dense
outputs rtol 2e-4 against float64.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla

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


def _csr_files(ctx, workdir, a_sp, prefix="A"):
    from bof_tpu.sparse import CsrFlashMatrix
    return CsrFlashMatrix.from_scipy(a_sp, backing="file",
                                     path_prefix=os.path.join(workdir,
                                                              prefix),
                                     ctx=ctx)


def _check_topk(got_s, got_l, want_dense, k):
    want_sorted = -np.sort(-want_dense, axis=1)[:, :k]
    np.testing.assert_allclose(got_s, want_sorted, rtol=2e-4, atol=1e-4)
    rows = np.arange(got_l.shape[0])[:, None]
    np.testing.assert_allclose(want_dense[rows, got_l], got_s, rtol=2e-4,
                               atol=1e-4)


def _same_on_every_rank(out):
    for o in out[1:]:
        for x, y in zip(o, out[0]):
            np.testing.assert_array_equal(x, y)
    return out[0]


@pytest.mark.parametrize("fused", [True, False])
def test_xml_rank_sharded_matches_single_chip(pools, ctx, rng, tmp_path,
                                              fused):
    """xml_rank(mesh=): the fused path (K2 + B8 on each rank's run of a
    band, all-gathers of rows x k) and the csrmm_sharded composition;
    rank 0 merges into panels every rank reads back."""
    from bof_tpu.apps import xml_rank
    from bof_tpu.core.flash_array import flash_empty
    from bof_tpu.parallel import make_mesh
    docs, vocab, n_labels, k = 96, 48, 25, 4
    a_sp = sps.random(docs, vocab, density=0.12, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(8))
    w_np = rng.standard_normal((n_labels, vocab)).astype(np.float32)
    A = _csr_files(ctx, str(tmp_path), a_sp)
    w = _write(ctx, str(tmp_path / "W"), w_np)
    s, l = _same_on_every_rank(pools.get(WORLD).run(
        jobs.xml_rank, str(tmp_path), "A", (docs, vocab), w, k,
        {"label_blk": 9, "fused": fused}))
    want = (a_sp @ w_np.T).astype(np.float32)
    _check_topk(s, l, want, k)
    W = flash_empty((n_labels, vocab), np.float32, ctx=ctx)
    W.write_all(w_np)
    rs, rl = xml_rank(A, W, k, label_blk=9, fused=fused,
                      mesh=make_mesh(WORLD), ctx=ctx)
    np.testing.assert_allclose(s, rs.read_all(), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("keeps", [True, False])
def test_xml_rank_sharded_bands_each_block_once(tmp_path, monkeypatch,
                                                keeps):
    """xml_rank(mesh=) on a world of one gloo rank, in panels of k labels:
    within a budget whose half holds every row block's bands each block is
    banded once a call and its bands serve the other panels; below any
    block's bands each block is banded once a panel.  Either way the
    scores and labels are the one-card fused path's bits."""
    import bof_tpu_torch
    from bof_tpu_torch.sparse import spmm_device as sdev
    from bof_tpu_torch.utils import METRICS
    from torch_dist_pool import one_rank_world
    docs, vocab, n_labels, k = 96, 48, 25, 4
    a_sp = sps.random(docs, vocab, density=0.12, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(8))
    w_np = np.random.default_rng(5).standard_normal(
        (n_labels, vocab)).astype(np.float32)
    made, real = [], sdev.ell_bands

    def counting(*args, **kw):
        bands = real(*args, **kw)
        made.append((sum(b.rows.nbytes + b.counts.nbytes + b.ja.nbytes
                         + b.va.nbytes for b in bands), len(bands)))
        return bands
    monkeypatch.setattr(sdev, "ell_bands", counting)

    def run(mesh, budget):
        ctx = bof_tpu_torch.FlashContext(bof_tpu_torch.FlashConfig(
            device="cpu", scratch_dir=str(tmp_path / ("one" if mesh is None else "mesh")),
            program_budget=budget, max_nnzs=128))
        try:
            A = bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
            W = bof_tpu_torch.mem_array((n_labels, vocab), np.float32,
                                        ctx=ctx, data=w_np)
            m0 = METRICS.snapshot()
            s, l = bof_tpu_torch.xml_rank(A, W, k, label_blk=k, fused=True,
                                          mesh=mesh, ctx=ctx)
            m1 = METRICS.snapshot()
            return (s.read_all(), l.read_all(),
                    *(m1.get(n, 0) - m0.get(n, 0)
                      for n in ("xml_rank.bands_built",
                                "xml_rank.bands_reused")))
        finally:
            ctx.destroy()

    s0, l0, _, _ = run(None, 64 << 20)
    blocks = list(made)
    budget = 64 << 20 if keeps else 2 * min(nb for nb, _ in blocks) - 1
    with one_rank_world() as mesh:
        s, l, built, reused = run(mesh, budget)
    np.testing.assert_array_equal(s, s0)
    np.testing.assert_array_equal(l, l0)
    _check_topk(s, l, (a_sp @ w_np.T).astype(np.float32), k)
    one_pass, panels = sum(n for _, n in blocks), -(-n_labels // k)
    assert len(blocks) > 2
    assert built == (one_pass if keeps else one_pass * panels)
    assert reused == (one_pass * (panels - 1) if keeps else 0)


def test_xml_rank_composition_waits_for_rank0_merge(pools, ctx, rng,
                                                    tmp_path):
    """The composition path reuses one score panel for every label block:
    with rank 0's merges slowed down, the other ranks must still not
    write the next block's scores before rank 0 has read this block's."""
    docs, vocab, n_labels, k = 96, 48, 25, 4
    a_sp = sps.random(docs, vocab, density=0.12, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(8))
    w_np = rng.standard_normal((n_labels, vocab)).astype(np.float32)
    _csr_files(ctx, str(tmp_path), a_sp)
    w = _write(ctx, str(tmp_path / "W"), w_np)
    s, l = _same_on_every_rank(pools.get(WORLD).run(
        jobs.xml_rank, str(tmp_path), "A", (docs, vocab), w, k,
        {"label_blk": 9, "doc_blk": 8, "fused": False}, 0.05))
    _check_topk(s, l, (a_sp @ w_np.T).astype(np.float32), k)


@pytest.mark.parametrize("one_pass", [None, True])
def test_lanczos_sharded_matches_scipy(pools, ctx, rng, tmp_path, one_pass):
    """block_lanczos_svd(mesh=): by default every operator application is
    two csrmm_sharded passes into shared W/U panels; one_pass=True runs
    the single streaming pass with both ELL halves sharded (one
    all-gather of W a band, one all-reduce of U)."""
    from bof_tpu.apps import block_lanczos_svd
    from bof_tpu.parallel import make_mesh
    ctx.config.max_nnzs = 2048
    m, k, L = 200, 90, 4
    a_sp = sps.random(m, k, density=0.06, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(4))
    A = _csr_files(ctx, str(tmp_path), a_sp)
    kw = {"tol": 1e-9, "one_pass": one_pass}
    sigma, v = _same_on_every_rank(pools.get(WORLD).run(
        jobs.lanczos, str(tmp_path), "A", (m, k), L, kw,
        {"max_nnzs": 2048}))
    want = np.sort(spla.svds(a_sp.astype(np.float64), k=L,
                             return_singular_vectors=False))[::-1]
    np.testing.assert_allclose(sigma, want, rtol=1e-3)
    ref, _ = block_lanczos_svd(A, L, mesh=make_mesh(WORLD), ctx=ctx, **kw)
    np.testing.assert_allclose(sigma, ref, rtol=1e-4)


def _planted(n_topics=3, docs_per=80, vocab_per=30):
    rows, cols = [], []
    rs = np.random.RandomState(2)
    for t in range(n_topics):
        for d in range(docs_per):
            for wd in t * vocab_per + rs.randint(0, vocab_per, 12):
                rows.append(t * docs_per + d)
                cols.append(wd)
    a_sp = sps.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                          shape=(n_topics * docs_per, n_topics * vocab_per))
    a_sp.sum_duplicates()
    return a_sp


@pytest.mark.parametrize("sample_rate", [1.0, 0.5])
def test_topic_model_sharded_recovers_topics(pools, ctx, tmp_path,
                                             sample_rate):
    """topic_model(mesh=): csrmm_sharded projection into a shared P, then
    kmeans_fit_sharded (or, sampled, a one-card fit on the sample and one
    lloyds_iter_ooc_sharded assignment pass)."""
    from bof_tpu.apps import topic_model
    from bof_tpu.parallel import make_mesh
    n_topics, docs_per = 3, 80
    a_sp = _planted(n_topics, docs_per)
    ctx.config.max_nnzs = 2048
    A = _csr_files(ctx, str(tmp_path), a_sp)
    kw = {"proj_dim": 16, "n_iters": 8, "sample_rate": sample_rate}
    tw, labels = _same_on_every_rank(pools.get(WORLD).run(
        jobs.topic_model, str(tmp_path), "A", a_sp.shape, n_topics, kw,
        {"max_nnzs": 2048}))
    docs = a_sp.shape[0]
    purity = sum(np.bincount(labels[t * docs_per:(t + 1) * docs_per],
                             minlength=n_topics).max()
                 for t in range(n_topics))
    assert purity / docs > 0.9
    want_tw, want_labels = topic_model(A, n_topics, mesh=make_mesh(WORLD),
                                       ctx=ctx, **kw)
    assert (labels != want_labels).mean() <= 0.01
    if np.array_equal(labels, want_labels):
        np.testing.assert_allclose(tw, want_tw, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- drivers

def _run_driver(pools, tmp_path, module, argv):
    return pools.get(2).run(jobs.driver, str(tmp_path), module, argv)


def test_gemm_driver_sharded(pools, ctx, rng, tmp_path):
    """drivers.gemm --sharded (bof_tpu's flag) on 2 ranks, C/T/N, alpha
    and beta, both dtypes."""
    m, n, k = 64, 48, 40
    for dt in (np.float32, np.float64):
        a = rng.standard_normal((k, m)).astype(dt)
        b = rng.standard_normal((k, n)).astype(dt)
        c0 = rng.standard_normal((m, n)).astype(dt)
        paths = [str(tmp_path / f"{nm}{dt.__name__}") for nm in "ABC"]
        for p_, x in zip(paths, (a, b, c0)):
            _write(ctx, p_, x, "C")
        _run_driver(pools, tmp_path, "gemm", paths + [
            str(m), str(n), str(k), "--ta", "T", "--order", "C",
            "--alpha", "0.5", "--beta", "2", "--blk", "16", "--dtype",
            np.dtype(dt).name, "--sharded"])
        got = bof_tpu.map_array(paths[2], (m, n), dt, "C",
                                ctx=ctx).read_all()
        want = 0.5 * (a.T.astype(np.float64) @ b) + 2 * c0
        np.testing.assert_allclose(got, want, rtol=2e-4 if dt == np.float32
                                   else 1e-12, atol=1e-4)


def test_csrmm_driver_sharded(pools, ctx, rng, tmp_path):
    m, k, n = 300, 90, 16
    a_sp = sps.random(m, k, density=0.05, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(3))
    _csr_files(ctx, str(tmp_path), a_sp)
    b_np = rng.standard_normal((k, n)).astype(np.float32)
    _write(ctx, str(tmp_path / "B"), b_np)
    _run_driver(pools, tmp_path, "csrmm", [
        str(tmp_path / "A"), str(m), str(k), str(tmp_path / "B"), str(n),
        str(tmp_path / "C"), "--alpha", "2", "--create-c", "--sharded"])
    got = np.fromfile(str(tmp_path / "C"), np.float32).reshape(m, n)
    np.testing.assert_allclose(got, 2 * (a_sp @ b_np), rtol=2e-4,
                               atol=1e-4)


def test_sharded_driver_argument_errors():
    """bof_tpu's usage errors, before any file is opened or group made:
    csrmm --sharded takes 'N' only and no float64; kmeans --sharded no
    float64; gemm --resume-journal is single-card; and the port's own:
    csrmm --sharded keeps C in its file, not in memory (--pmem)."""
    import importlib
    for module, argv in (
            ("csrmm", ["A", "4", "4", "B", "4", "C", "--ta", "T"]),
            ("csrmm", ["A", "4", "4", "B", "4", "C", "--dtype", "float64"]),
            ("csrmm", ["A", "4", "4", "B", "4", "C", "--pmem"]),
            ("kmeans", ["P", "4", "2", "2", "--dtype", "float64"]),
            ("gemm", ["A", "B", "C", "4", "4", "4", "--resume-journal",
                      "J"])):
        mod = importlib.import_module(f"bof_tpu_torch.drivers.{module}")
        with pytest.raises(SystemExit) as e:
            mod.main(argv + ["--sharded", "--device", "cpu"])
        assert e.value.code == 2


def test_kmeans_driver_sharded(pools, ctx, rng, tmp_path):
    """drivers.kmeans --sharded: bof_tpu's seeding bits and the mesh fit's
    centers, labels written by each rank into one file."""
    from bof_tpu import mem_array
    from bof_tpu.parallel import kmeans_fit_sharded, make_mesh
    n, d, k = 500, 6, 4
    pts = (rng.standard_normal((n, d)) * 0.05
           + rng.integers(0, k, n)[:, None]).astype(np.float32)
    pts.tofile(str(tmp_path / "P"))
    out = _run_driver(pools, tmp_path, "kmeans", [
        str(tmp_path / "P"), str(n), str(d), str(k), "--iters", "3",
        "--labels-out", str(tmp_path / "L"), "--sharded"])
    centers, inertia = _same_on_every_rank(out)
    P = mem_array((n, d), np.float32, data=pts, ctx=ctx)
    L = mem_array((n,), np.int32, ctx=ctx)
    ref_c, ref_i = kmeans_fit_sharded(P, k, n_iters=3, seed=0, labels_out=L,
                                      mesh=make_mesh(2), ctx=ctx)
    np.testing.assert_allclose(centers, ref_c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(inertia, ref_i, rtol=1e-4)
    np.testing.assert_array_equal(np.fromfile(str(tmp_path / "L"), np.int32),
                                  L.read_all())


def test_eigensolver_driver_sharded(pools, ctx, tmp_path):
    """drivers.eigensolver --sharded: every application two csrmm_sharded
    passes, bof_tpu's singular values."""
    from bof_tpu.apps import block_lanczos_svd
    from bof_tpu.parallel import make_mesh
    m, k = 200, 90
    a_sp = sps.random(m, k, density=0.06, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(4))
    A = _csr_files(ctx, str(tmp_path), a_sp)
    sigma, _ = _same_on_every_rank(_run_driver(pools, tmp_path,
                                               "eigensolver", [
        str(tmp_path / "A"), str(m), str(k), "3", "--iters", "3",
        "--sharded"]))
    ref, _ = block_lanczos_svd(A, 3, n_restarts=3, one_pass=False,
                               mesh=make_mesh(2), ctx=ctx)
    np.testing.assert_allclose(sigma, ref, rtol=1e-4)


def test_xml_rank_driver_sharded(pools, ctx, rng, tmp_path):
    docs, vocab, n_labels, k = 96, 48, 25, 4
    a_sp = sps.random(docs, vocab, density=0.12, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(8))
    _csr_files(ctx, str(tmp_path), a_sp)
    w_np = rng.standard_normal((n_labels, vocab)).astype(np.float32)
    w_np.tofile(str(tmp_path / "W"))
    s, l = _same_on_every_rank(_run_driver(pools, tmp_path, "xml_rank", [
        str(tmp_path / "A"), str(docs), str(vocab), str(tmp_path / "W"),
        str(n_labels), str(k), "--label-blk", "9", "--scores",
        str(tmp_path / "S"), "--labels", str(tmp_path / "L"), "--sharded"]))
    _check_topk(s, l, (a_sp @ w_np.T).astype(np.float32), k)
    np.testing.assert_array_equal(
        np.fromfile(str(tmp_path / "L"), np.int32).reshape(docs, k), l)


def test_topic_model_driver_sharded(pools, ctx, tmp_path):
    from bof_tpu.apps import topic_model
    from bof_tpu.parallel import make_mesh
    a_sp = _planted()
    A = _csr_files(ctx, str(tmp_path), a_sp)
    docs, vocab = a_sp.shape
    tw, labels = _same_on_every_rank(_run_driver(
        pools, tmp_path, "topic_model", [
            str(tmp_path / "A"), str(docs), str(vocab), "3", "--proj-dim",
            "16", "--iters", "6", "--out", str(tmp_path / "T"),
            "--sharded"]))
    np.testing.assert_array_equal(
        np.fromfile(str(tmp_path / "T"), np.float32).reshape(tw.shape), tw)
    want_tw, want_labels = topic_model(A, 3, proj_dim=16, n_iters=6,
                                       mesh=make_mesh(2), ctx=ctx)
    assert (labels != want_labels).mean() <= 0.01
    if np.array_equal(labels, want_labels):
        np.testing.assert_allclose(tw, want_tw, rtol=1e-4, atol=1e-6)


def test_torchrun_starts_the_sharded_driver(ctx, rng, tmp_path):
    """`torchrun --nproc-per-node 2 -m bof_tpu_torch.drivers.gemm ...
    --sharded`: make_mesh initializes the world torchrun describes in the
    environment (gloo here), and the two ranks' C shards make the whole
    product."""
    import subprocess
    import sys
    m, n, k = 64, 48, 40
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    paths = [str(tmp_path / nm) for nm in "ABC"]
    for p_, x in zip(paths, (a, b, np.zeros((m, n), np.float32))):
        x.tofile(p_)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "-m", "bof_tpu_torch.drivers.gemm", *paths, str(m), str(n),
         str(k), "--blk", "16", "--sharded", "--device", "cpu", "--scratch",
         str(tmp_path / "s")], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stderr.count("gemm_sharded 64x48x40 on 1x2 mesh") == 2
    got = np.fromfile(paths[2], np.float32).reshape(m, n)
    np.testing.assert_allclose(got, a.astype(np.float64) @ b, rtol=2e-4,
                               atol=1e-4)
