"""README.md's quick start of the port (its `bof_tpu_torch` section), run at
toy size on the CPU, after tests/test_readme_api.py: every name and call
shape it shows must exist and work.  gemm, csrmm and block Lanczos' sigma
are held to bof_tpu's results on the same files (rtol 2e-4), the rest to
numpy/scipy."""
import numpy as np
import scipy.sparse as sps

from torch_pair import REF


def test_readme_quickstart_api(tmp_path):
    import bof_tpu_torch as bt

    rng = np.random.default_rng(0)
    n, docs, vocab = 64, 96, 64
    for name in ("A", "B"):
        rng.standard_normal((n, n)).astype(np.float32).tofile(
            str(tmp_path / f"{name}.bin"))
    a_sp = sps.random(docs, vocab, density=0.1, format="csr",
                      dtype=np.float32,
                      random_state=np.random.RandomState(0))
    bs = rng.standard_normal((vocab, 16)).astype(np.float32)
    bs.tofile(str(tmp_path / "Bs.bin"))
    p_np = rng.standard_normal((512, 8)).astype(np.float32)
    p_np.tofile(str(tmp_path / "P.bin"))
    w_np = rng.standard_normal((10, vocab)).astype(np.float32)
    w_np.tofile(str(tmp_path / "W.bin"))

    ctx = bt.flash_setup(str(tmp_path / "scratch"),
                         bt.FlashConfig(device="cpu"))
    try:
        path = lambda name: str(tmp_path / name)  # noqa: E731
        A = bt.map_array(path("A.bin"), (n, n), np.float32, "R", ctx=ctx)
        B = bt.map_array(path("B.bin"), (n, n), np.float32, "R", ctx=ctx)
        C = bt.map_array(path("C.bin"), (n, n), np.float32, "R",
                         create=True, ctx=ctx)
        bt.gemm(A, B, C, alpha=1.0, beta=0.0)

        bt.CsrFlashMatrix.from_scipy(a_sp, backing="file",
                                     path_prefix=path("S"), ctx=ctx)
        S = bt.CsrFlashMatrix.map_files(path("S"), (docs, vocab), ctx=ctx)
        Bs = bt.map_array(path("Bs.bin"), (vocab, 16), np.float32, "R",
                          ctx=ctx)
        Cs = bt.map_array(path("Cs.bin"), (docs, 16), np.float32, "R",
                          create=True, ctx=ctx)
        bt.csrmm(S, Bs, Cs, alpha=1.0, beta=0.0, transa="N")
        y = bt.csrgemv(S, np.ones(vocab, np.float32))

        P = bt.map_array(path("P.bin"), (512, 8), np.float32, ctx=ctx)
        centers, inertia = bt.kmeans_fit(P, 4, n_iters=3, seed=0)

        sigma, V = bt.block_lanczos_svd(S, 2, n_restarts=2)
        U = bt.apply_gram(S, V)
        W = bt.map_array(path("W.bin"), (10, vocab), np.float32, "R",
                         ctx=ctx)
        scores, labels = bt.xml_rank(S, W, 3)
        topics, doc_labels = bt.topic_model(S, 2, proj_dim=8,
                                            sample_rate=0.5)
        got_c, got_cs = C.read_all(), Cs.read_all()
        got_scores, got_labels = scores.read_all(), labels.read_all()
    finally:
        bt.flash_destroy()

    a, b = (np.fromfile(path(f"{x}.bin"), np.float32).reshape(n, n)
            for x in ("A", "B"))
    np.testing.assert_allclose(got_c, a.astype(np.float64) @ b, rtol=2e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got_cs, a_sp @ bs, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(y, a_sp @ np.ones(vocab, np.float32),
                               rtol=1e-4, atol=1e-4)
    assert centers.shape == (4, 8) and np.isfinite(inertia)
    assert sigma.shape == (2,) and V.shape == (vocab, 2)
    a64 = a_sp.astype(np.float64)
    np.testing.assert_allclose(U, a64.T @ (a64 @ V.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)
    dense = (a_sp @ w_np.T).astype(np.float32)
    np.testing.assert_allclose(got_scores, -np.sort(-dense, axis=1)[:, :3],
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(dense[np.arange(docs)[:, None], got_labels],
                               got_scores, rtol=2e-4, atol=1e-4)
    assert topics.shape == (2, vocab) and doc_labels.shape == (docs,)

    ctx = REF.bt.flash_setup(str(tmp_path / "ref_scratch"))
    try:  # bof_tpu's gemm and csrmm on the same files
        rA, rB = (REF.bt.map_array(path(f"{x}.bin"), (n, n), np.float32,
                                   "R", ctx=ctx) for x in ("A", "B"))
        rC = REF.bt.mem_array((n, n), np.float32, ctx=ctx)
        REF.bt.gemm(rA, rB, rC, alpha=1.0, beta=0.0)
        rS = REF.bt.CsrFlashMatrix.map_files(path("S"), (docs, vocab),
                                             ctx=ctx)
        rBs = REF.bt.map_array(path("Bs.bin"), (vocab, 16), np.float32, "R",
                               ctx=ctx)
        rCs = REF.bt.mem_array((docs, 16), np.float32, ctx=ctx)
        REF.bt.csrmm(rS, rBs, rCs)
        ref_sigma, _ = REF.bt.block_lanczos_svd(rS, 2, n_restarts=2)
        np.testing.assert_allclose(got_c, rC.read_all(), rtol=2e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(got_cs, rCs.read_all(), rtol=2e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(sigma, ref_sigma, rtol=2e-4)
    finally:
        REF.bt.flash_destroy()
