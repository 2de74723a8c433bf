"""The port's applications (block eigensolver, XML ranking, topic model)
against bof_tpu's, on the same seeded inputs, on the CPU; and B8, the
fused ranking step's row top-k, against jax.lax.top_k.

Every single-process case of tests/test_apps.py runs here through both
packages (bof_tpu on CPU JAX, the port on `device='cpu'`, where K2 and B8
take their plain versions).  Tolerances: the operator U = A^T A V against
float64 and bof_tpu rtol 1e-4, atol 1e-4 (tests/test_apps.py:261); sigma
against bof_tpu rtol 1e-4 and against scipy's svds rtol 1e-3; XML scores
by `_check_topk` (rtol 2e-4, atol 1e-4) and labels equal to bof_tpu's
wherever neighbouring scores differ by more than 1e-5 max|s|; topic-word
matrices rtol 1e-4, atol 1e-6; topic labels equal but at float64
near-ties.  B8's plain version equals lax.top_k bit for bit.
"""
import dataclasses
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import bof_tpu
import bof_tpu_torch
from bof_tpu.ops import kmeans as ref_km
from bof_tpu.utils import METRICS as REF_METRICS
from bof_tpu_torch.ops import kmeans as port_km
from bof_tpu_torch.ops import topk_cuda
from bof_tpu_torch.utils import METRICS as PORT_METRICS

# the modules (each package's apps/__init__ binds the names topic_model
# and xml_rank to the functions)
ref_eig, ref_tm, ref_xml, port_eig, port_tm, port_xml = (
    importlib.import_module(f"{pkg}.apps.{mod}")
    for pkg in ("bof_tpu", "bof_tpu_torch")
    for mod in ("eigensolver", "topic_model", "xml_rank"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ctxs(tmp_path):
    """(bof_tpu context, port context on the CPU): the reference tests'
    configuration in both."""
    ref_cfg = bof_tpu.FlashConfig(scratch_dir=str(tmp_path / "scratch"),
                                  n_io_threads=4, n_compute_threads=2,
                                  program_budget=256 << 20)
    port_cfg = bof_tpu_torch.config_from_reference(
        dataclasses.asdict(ref_cfg), device="cpu")
    ref, port = bof_tpu.FlashContext(ref_cfg), bof_tpu_torch.FlashContext(
        port_cfg)
    yield ref, port
    ref.destroy()
    port.destroy()


def _set(ctxs, **kw):
    for c in ctxs:
        for key, val in kw.items():
            setattr(c.config, key, val)


def _csr(ctxs, a_sp, **kw):
    return (bof_tpu.CsrFlashMatrix.from_scipy(a_sp, ctx=ctxs[0], **kw),
            bof_tpu_torch.CsrFlashMatrix.from_scipy(a_sp, ctx=ctxs[1], **kw))


def _svds(a_sp, L):
    return np.sort(spla.svds(a_sp.astype(np.float64), k=L,
                             return_singular_vectors=False))[::-1]


def _check_vectors(a_sp, sigma, v):
    """Right singular vectors: A^T A v_i = sigma_i^2 v_i (the reference
    tests' residual bound)."""
    ata = (a_sp.T @ a_sp).toarray().astype(np.float64)
    for i in range(len(sigma)):
        resid = np.linalg.norm(ata @ v[:, i] - sigma[i] ** 2 * v[:, i])
        assert resid < 1e-2 * max(sigma[i] ** 2, 1.0)


def _random_a(m=300, k=120, density=0.05, seed=3):
    return sps.random(m, k, density=density, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(seed))


# ------------------------------------------------------------ eigensolver

@pytest.mark.parametrize("one_pass", [True, False])
def test_block_power_svd_matches_reference(ctxs, one_pass):
    _set(ctxs, max_nnzs=2048)
    L = 5
    a_sp = _random_a()
    A_ref, A_port = _csr(ctxs, a_sp)
    want_s, _ = ref_eig.block_power_svd(A_ref, L, n_iters=40, tol=1e-9,
                                        one_pass=one_pass, ctx=ctxs[0])
    sigma, v = port_eig.block_power_svd(A_port, L, n_iters=40, tol=1e-9,
                                        one_pass=one_pass, ctx=ctxs[1])
    np.testing.assert_allclose(sigma, want_s, rtol=1e-4)
    np.testing.assert_allclose(sigma, _svds(a_sp, L), rtol=1e-3)
    assert v.dtype == np.float32 and v.shape == (a_sp.shape[1], L)
    _check_vectors(a_sp, sigma, v)


@pytest.mark.parametrize("one_pass", [True, False])
def test_block_lanczos_svd_matches_reference(ctxs, one_pass):
    _set(ctxs, max_nnzs=2048)
    L = 5
    a_sp = _random_a()
    A_ref, A_port = _csr(ctxs, a_sp)
    want_s, _ = ref_eig.block_lanczos_svd(A_ref, L, tol=1e-9,
                                          one_pass=one_pass, ctx=ctxs[0])
    sigma, v = port_eig.block_lanczos_svd(A_port, L, tol=1e-9,
                                          one_pass=one_pass, ctx=ctxs[1])
    np.testing.assert_allclose(sigma, want_s, rtol=1e-4)
    np.testing.assert_allclose(sigma, _svds(a_sp, L), rtol=1e-3)
    _check_vectors(a_sp, sigma, v)


def _clustered(n, lead, tail_top):
    """A diagonal matrix whose leading spectrum is `lead` (clustered), the
    rest spread from tail_top down to 0.1."""
    s = np.concatenate([lead, np.linspace(tail_top, 0.1, n - len(lead))])
    return sps.diags(s.astype(np.float32), format="csr", dtype=np.float32), s


def test_lanczos_beats_power_on_clustered_spectrum(ctxs):
    """Paper parity (Table 4): on a clustered spectrum block Lanczos
    reaches the same accuracy with fewer operator applications than block
    power iteration (or power stops early, less accurate); the port's
    sigmas equal bof_tpu's."""
    _set(ctxs, max_nnzs=1 << 20)
    L = 4
    a_sp, s = _clustered(160, [10.0, 9.97, 9.95, 9.93, 9.91, 9.90], 5.0)
    A_ref, A_port = _csr(ctxs, a_sp)
    want = np.sort(s)[::-1][:L].astype(np.float64)

    before = PORT_METRICS.get("eig.op_applies")
    sig_l, _ = port_eig.block_lanczos_svd(A_port, L, tol=1e-8,
                                          n_restarts=12, ctx=ctxs[1])
    lanczos_applies = PORT_METRICS.get("eig.op_applies") - before
    np.testing.assert_allclose(sig_l, want, rtol=1e-4)
    before = PORT_METRICS.get("eig.op_applies")
    sig_p, _ = port_eig.block_power_svd(A_port, L, n_iters=60, tol=1e-8,
                                        ctx=ctxs[1])
    power_applies = PORT_METRICS.get("eig.op_applies") - before
    power_err = np.abs(sig_p - want).max() / want.max()
    assert (lanczos_applies < power_applies
            or power_err > np.abs(sig_l - want).max() / want.max() * 2), (
        f"lanczos {lanczos_applies} vs power {power_applies} applies, "
        f"power_err {power_err:.2e}")

    before = REF_METRICS.get("eig.op_applies")
    ref_l, _ = ref_eig.block_lanczos_svd(A_ref, L, tol=1e-8, n_restarts=12,
                                         ctx=ctxs[0])
    assert REF_METRICS.get("eig.op_applies") - before == lanczos_applies
    np.testing.assert_allclose(sig_l, ref_l, rtol=1e-4)
    ref_p, _ = ref_eig.block_power_svd(A_ref, L, n_iters=60, tol=1e-8,
                                       ctx=ctxs[0])
    np.testing.assert_allclose(sig_p, ref_p, rtol=1e-4)


@pytest.mark.parametrize("writer", ["bof_tpu", "port"])
def test_lanczos_checkpoint_resumes_across_packages(ctxs, tmp_path, writer):
    """A Lanczos run interrupted between restart cycles leaves its state
    file; the other package resumes from it, finishes, deletes it, and
    gives the sigmas of an uninterrupted run."""
    _set(ctxs, max_nnzs=1 << 20)
    L = 3
    a_sp, s = _clustered(120, [8.0, 7.98, 7.96, 7.90], 4.0)
    A_ref, A_port = _csr(ctxs, a_sp)
    want = np.sort(s)[::-1][:L].astype(np.float64)
    state = str(tmp_path / "lz_state.npz")
    first, second = ((ref_eig, A_ref, ctxs[0]), (port_eig, A_port, ctxs[1]))
    if writer == "port":
        first, second = second, first

    mod, A, ctx = first
    mod.block_lanczos_svd(A, L, tol=1e-14, n_restarts=2, seed=3,
                          state_path=state, ctx=ctx)
    assert os.path.exists(state)  # interrupted: state persisted
    with np.load(state) as st:
        assert int(st["rnd"]) == 1
    mod, A, ctx = second
    sig2, _ = mod.block_lanczos_svd(A, L, tol=1e-10, n_restarts=10, seed=3,
                                    state_path=state, ctx=ctx)
    np.testing.assert_allclose(sig2, want, rtol=1e-5)
    assert not os.path.exists(state)
    straight, _ = first[0].block_lanczos_svd(first[1], L, tol=1e-10,
                                             n_restarts=10, seed=3,
                                             ctx=first[2])
    np.testing.assert_allclose(sig2, straight, rtol=1e-4)


def _skewed(seed, rng, big_row, big_col, big_val):
    m, k = 500, 130
    a_sp = sps.random(m, k, density=0.06, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(seed)).tolil()
    a_sp[big_row, :] = rng.standard_normal(k)   # mega-row skews ELL ranges
    a_sp[big_col, :90] = big_val                # mega-column block too
    return a_sp.tocsr()


def test_one_pass_device_matches_host(ctxs):
    """The device one-pass operator (both halves on K2's plain version
    here; fp64 U on the host) against its host path, bof_tpu's two paths
    and float64, on skewed blocks that split into several ELL ranges."""
    rng = np.random.default_rng(0)
    _set(ctxs, max_nnzs=2048, hbm_budget=1 << 21)
    b = 7
    a_sp = _skewed(5, rng, 123, 348, 1.5)
    A_ref, A_port = _csr(ctxs, a_sp)
    v_np = rng.standard_normal((a_sp.shape[1], b))
    _set(ctxs, sparse_compute="host")
    u_host = port_eig._apply_ata_one_pass(A_port, v_np, ctxs[1])
    u_dev = port_eig._apply_ata_one_pass_device(A_port, v_np, ctxs[1])
    want = a_sp.T.astype(np.float64) @ (a_sp.astype(np.float64) @ v_np)
    ref_host = ref_eig._apply_ata_one_pass(A_ref, v_np, ctxs[0])
    ref_dev = ref_eig._apply_ata_one_pass_device(A_ref, v_np, ctxs[0])
    for got in (u_host, u_dev, ref_host, ref_dev):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(u_dev, ref_dev, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(u_host, ref_host)  # the same scipy calls
    # the dispatcher honors sparse_compute='device'
    _set(ctxs, sparse_compute="device")
    np.testing.assert_array_equal(
        port_eig._apply_ata_one_pass(A_port, v_np, ctxs[1]), u_dev)


def test_block_power_svd_device_one_pass(ctxs):
    """End-to-end solver on the device one-pass operator."""
    _set(ctxs, max_nnzs=2048, sparse_compute="device")
    L = 5
    a_sp = _random_a()
    A_ref, A_port = _csr(ctxs, a_sp)
    sigma, _ = port_eig.block_power_svd(A_port, L, n_iters=40, tol=1e-9,
                                        one_pass=True, ctx=ctxs[1])
    want_s, _ = ref_eig.block_power_svd(A_ref, L, n_iters=40, tol=1e-9,
                                        one_pass=True, ctx=ctxs[0])
    np.testing.assert_allclose(sigma, want_s, rtol=1e-4)
    np.testing.assert_allclose(sigma, _svds(a_sp, L), rtol=1e-3)


def test_one_pass_fp64_routes_to_exact_host(ctxs):
    """fp64 CSR values: 'device' placement falls back to the exact host
    products in both packages (the port's kernels are fp32), matching
    scipy fp64 to 1e-12."""
    rng = np.random.default_rng(0)
    k, L = 120, 4
    a_sp = sps.random(300, k, density=0.05, format="csr", dtype=np.float64,
                      random_state=np.random.RandomState(11))
    a_sp.data *= np.exp(rng.uniform(-20, 20, a_sp.nnz))
    A_ref, A_port = _csr(ctxs, a_sp, val_dtype=np.float64)
    v = rng.standard_normal((k, L))
    _set(ctxs, sparse_compute="device")
    got = port_eig._apply_ata_one_pass(A_port, v, ctxs[1])
    v32 = v.astype(np.float32).astype(np.float64)
    want = a_sp.T @ (a_sp @ v32)  # the host path casts V once to f32
    denom = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) / denom < 1e-12
    if not jax.config.jax_enable_x64:
        np.testing.assert_array_equal(
            got, ref_eig._apply_ata_one_pass(A_ref, v, ctxs[0]))


# ------------------------------------------------------------ topic model

def _near_ties_only(p, c, got, want):
    """Where two label vectors differ, the float64 partial distances of the
    two centers are within 1e-5 * (|p|^2 + max|c|^2) of each other."""
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return True
    p64, c64 = p[diff].astype(np.float64), c.astype(np.float64)
    pd = (c64 * c64).sum(1)[None, :] - 2.0 * p64 @ c64.T
    rows = np.arange(diff.size)
    gap = np.abs(pd[rows, got[diff]] - pd[rows, want[diff]])
    scale = (p64 * p64).sum(1) + (c64 * c64).sum(1).max()
    return bool((gap <= 1e-5 * scale).all())


def _planted(n_topics, docs_per, vocab_per, words, seed):
    rows, cols = [], []
    rs = np.random.RandomState(seed)
    for t in range(n_topics):
        for d in range(docs_per):
            for w in t * vocab_per + rs.randint(0, vocab_per, words):
                rows.append(t * docs_per + d)
                cols.append(w)
    a_sp = sps.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                          shape=(n_topics * docs_per, n_topics * vocab_per))
    a_sp.sum_duplicates()
    return a_sp


def _port_topic_model(A, n_topics, ctx, monkeypatch, **kw):
    """The port's topic_model, recording the centers its labels were
    assigned to (the last call of kmeans_fit or lloyds_iter)."""
    seen = {}
    fit, step = port_tm.kmeans_fit, port_km.lloyds_iter

    def kmeans_fit(*a, **k):
        out = fit(*a, **k)
        seen["centers"] = out[0]
        return out

    def lloyds_iter(points, centers, *a, **k):
        seen["centers"] = centers
        return step(points, centers, *a, **k)
    monkeypatch.setattr(port_tm, "kmeans_fit", kmeans_fit)
    monkeypatch.setattr(port_km, "lloyds_iter", lloyds_iter)
    tw, labels = port_tm.topic_model(A, n_topics, ctx=ctx, **kw)
    return tw, labels, seen["centers"]


def _check_topics(a_sp, tw, labels, centers, want_tw, want_labels,
                  proj_dim, seed=0):
    """The port's topic model against bof_tpu's: labels equal but at
    float64 near-ties of the projected points (P = A R, R the model's
    seeded basis) to the port's centers; where they are equal the
    topic-word matrices within rtol 1e-4, atol 1e-6."""
    vocab = a_sp.shape[1]
    r_np = (np.random.default_rng(seed).standard_normal((vocab, proj_dim))
            / np.sqrt(proj_dim)).astype(np.float32)
    p64 = a_sp.astype(np.float64) @ r_np.astype(np.float64)
    assert _near_ties_only(p64, centers, labels, want_labels)
    if np.array_equal(labels, want_labels):
        np.testing.assert_allclose(tw, want_tw, rtol=1e-4, atol=1e-6)


def test_topic_model_recovers_planted_topics(ctxs, monkeypatch):
    """Disjoint-vocabulary topics: same-topic docs share a label and each
    topic's mass sits on its vocabulary slice; the port's model is
    bof_tpu's."""
    n_topics, docs_per, vocab_per = 4, 120, 50
    a_sp = _planted(n_topics, docs_per, vocab_per, 20, 0)
    _set(ctxs, max_nnzs=2048)
    A_ref, A_port = _csr(ctxs, a_sp)
    tw, labels, centers = _port_topic_model(A_port, n_topics, ctxs[1],
                                            monkeypatch, proj_dim=32,
                                            n_iters=10)
    want_tw, want_labels = ref_tm.topic_model(A_ref, n_topics, proj_dim=32,
                                              n_iters=10, ctx=ctxs[0])
    _check_topics(a_sp, tw, labels, centers, want_tw, want_labels, 32)
    docs = a_sp.shape[0]
    assert tw.shape == (n_topics, n_topics * vocab_per)
    np.testing.assert_allclose(tw.sum(1), 1.0, rtol=1e-5)
    purity = sum(np.bincount(labels[t * docs_per:(t + 1) * docs_per],
                             minlength=n_topics).max()
                 for t in range(n_topics))
    assert purity / docs > 0.9
    for t in range(n_topics):
        assert max(tw[t, s * vocab_per:(s + 1) * vocab_per].sum()
                   for s in range(n_topics)) > 0.85


def test_topic_model_sampled_clustering(ctxs, monkeypatch):
    """sample_rate < 1 (the paper's ISLE mode): clustering on a doc sample,
    one streaming assignment pass; planted topics recovered, and the
    port's model is bof_tpu's."""
    n_topics, docs_per, vocab_per = 3, 150, 40
    a_sp = _planted(n_topics, docs_per, vocab_per, 15, 1)
    _set(ctxs, max_nnzs=2048)
    A_ref, A_port = _csr(ctxs, a_sp)
    tw, labels, centers = _port_topic_model(A_port, n_topics, ctxs[1],
                                            monkeypatch, proj_dim=24,
                                            n_iters=8, sample_rate=0.4)
    want_tw, want_labels = ref_tm.topic_model(A_ref, n_topics, proj_dim=24,
                                              n_iters=8, sample_rate=0.4,
                                              ctx=ctxs[0])
    _check_topics(a_sp, tw, labels, centers, want_tw, want_labels, 24)
    docs = a_sp.shape[0]
    purity = sum(np.bincount(labels[t * docs_per:(t + 1) * docs_per],
                             minlength=n_topics).max()
                 for t in range(n_topics))
    assert purity / docs > 0.9
    for t in range(n_topics):
        assert max(tw[t, s * vocab_per:(s + 1) * vocab_per].sum()
                   for s in range(n_topics)) > 0.8


def test_lift_topics_streams_and_matches_dense_onehot(ctxs):
    """The lift equals A^T one_hot(labels) with a tiny nnz budget (many row
    blocks), bit for bit bof_tpu's (the same host code); the scatter-add
    form of the large-T branch gives the same sums."""
    rng = np.random.default_rng(0)
    docs, vocab, n_topics = 500, 80, 7
    a_sp = sps.random(docs, vocab, density=0.08, format="csr",
                      dtype=np.float32, random_state=np.random.RandomState(1))
    A_ref, A_port = _csr(ctxs, a_sp)
    labels = rng.integers(0, n_topics, docs).astype(np.int32)
    onehot = np.zeros((docs, n_topics), np.float32)
    onehot[np.arange(docs), labels] = 1.0
    want = (a_sp.T @ onehot).T
    _set(ctxs, max_nnzs=256)
    got = port_tm.lift_topics(A_port, labels, n_topics, ctx=ctxs[1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        got, ref_tm.lift_topics(A_ref, labels, n_topics, ctx=ctxs[0]))
    ia = A_port.read_ia()
    T2 = np.zeros((n_topics, vocab), np.float32)
    np.add.at(T2, (np.repeat(labels.astype(np.int64), np.diff(ia)),
                   a_sp.indices), a_sp.data)
    np.testing.assert_allclose(T2, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="labels shape"):
        port_tm.lift_topics(A_port, labels[:-1], n_topics, ctx=ctxs[1])


@pytest.mark.parametrize("writer", ["bof_tpu", "port"])
def test_topic_model_state_resumes_across_packages(ctxs, tmp_path,
                                                   monkeypatch, writer):
    """topic_model's state_path is k-means' state: a model interrupted
    in its clustering's fourth Lloyd pass resumes in the other
    package, which consumes the state and ends where an uninterrupted
    model ends."""
    n_topics = 3
    a_sp = _planted(n_topics, 100, 30, 12, 2)
    _set(ctxs, max_nnzs=2048)
    A_ref, A_port = _csr(ctxs, a_sp)
    kw = dict(proj_dim=16, n_iters=6, seed=4)
    state = str(tmp_path / "tm_state.npz")
    crash_mod = ref_km if writer == "bof_tpu" else port_km
    calls = []
    real = crash_mod._lloyds_iter_device

    def crash_on_fourth(*a, **k):
        calls.append(1)
        if len(calls) == 4:
            raise KeyboardInterrupt("simulated crash")
        return real(*a, **k)
    monkeypatch.setattr(crash_mod, "_lloyds_iter_device", crash_on_fourth)
    first, second = ((ref_tm, A_ref, ctxs[0]), (port_tm, A_port, ctxs[1]))
    if writer == "port":
        first, second = second, first
    with pytest.raises(KeyboardInterrupt):
        first[0].topic_model(first[1], n_topics, state_path=state,
                             ctx=first[2], **kw)
    assert os.path.exists(state)  # interrupted: state persisted
    monkeypatch.setattr(crash_mod, "_lloyds_iter_device", real)
    tw, labels = second[0].topic_model(second[1], n_topics,
                                       state_path=state, ctx=second[2], **kw)
    assert not os.path.exists(state)
    want_tw, want_labels = ref_tm.topic_model(A_ref, n_topics, ctx=ctxs[0],
                                              **kw)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(tw, want_tw, rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------ XML ranking

def _check_topk(got_s, got_l, want_dense_scores, k):
    """tests/test_apps.py's order/tie-robust check: scores match the golden
    top-k, and each label's true score is the reported score."""
    want_sorted = -np.sort(-want_dense_scores, axis=1)[:, :k]
    np.testing.assert_allclose(got_s, want_sorted, rtol=2e-4, atol=1e-4)
    rows = np.arange(got_l.shape[0])[:, None]
    np.testing.assert_allclose(want_dense_scores[rows, got_l], got_s,
                               rtol=2e-4, atol=1e-4)


def _labels_match_apart_from_ties(got_l, want_l, want_s):
    """Labels equal bof_tpu's at every rank whose score stands more than
    1e-5 max|s| from its neighbours' (closer ones may swap)."""
    gap = 1e-5 * float(np.abs(want_s[np.isfinite(want_s)]).max())
    with np.errstate(invalid="ignore"):  # -inf - -inf: no order to keep
        d = np.abs(np.diff(want_s, axis=1))
    apart = np.ones(want_s.shape, bool)
    apart[:, 1:] &= d > gap
    apart[:, :-1] &= d > gap
    np.testing.assert_array_equal(got_l[apart], want_l[apart])


def _xml_case(ctxs, docs, vocab, n_labels, density, seed, col_major):
    rng = np.random.default_rng(0)
    if density is None:
        a_sp = _zipf_docs(docs, vocab, seed)
    else:
        a_sp = sps.random(docs, vocab, density=density, format="csr",
                          dtype=np.float32,
                          random_state=np.random.RandomState(seed))
    w_np = rng.standard_normal((n_labels, vocab)).astype(np.float32)
    A_ref, A_port = _csr(ctxs, a_sp)
    Ws = []
    for pkg, ctx in ((bof_tpu, ctxs[0]), (bof_tpu_torch, ctxs[1])):
        if col_major:
            W = pkg.flash_empty((vocab, n_labels), np.float32, order="C",
                                ctx=ctx)
            W.write_all(w_np.T)  # label-major lines, like row-major W
        else:
            W = pkg.flash_empty((n_labels, vocab), np.float32, ctx=ctx)
            W.write_all(w_np)
        Ws.append(W)
    return a_sp, w_np, (A_ref, Ws[0]), (A_port, Ws[1])


def _zipf_docs(docs, vocab, seed):
    """Documents shaped like a tf-idf corpus, by the XML benchmark cell's
    own generator: log-normal row lengths (mean 24), Zipf-skewed columns
    without repeats in a row."""
    from oocbench.entries.xml_rank import docs_csr
    ia, ja, va = docs_csr({"docs": docs, "vocab": vocab,
                           "nnz_per_doc_mean": 24, "nnz_per_doc_sigma": 1.0,
                           "nnz_per_doc_max": 2000, "zipf_exponent": 1.0},
                          seed, "cpu")
    return sps.csr_matrix((va.numpy(), ja.numpy(), ia.numpy()),
                          shape=(docs, vocab))


# (docs, vocab, labels, density (None: Zipf-skewed), seed, k, label_blk)
XML_INPUTS = {
    "uniform": (257, 96, 83, 0.1, 5, 7, 19),
    # vocab odd: W's rows (4 * vocab bytes) sit off 4 KiB alignment, as
    # Amazon-670K's 543,636 B do; labels not a multiple of the panel
    "zipf": (300, 1001, 203, None, 2**31 + 19, 5, 64),
}


@pytest.mark.parametrize("fused,docs", [
    (True, "uniform"), (False, "uniform"), (True, "zipf"), (False, "zipf")],
    ids=["True", "False", "True-zipf", "False-zipf"])
def test_xml_rank_matches_dense_topk(ctxs, fused, docs):
    """Many label and doc blocks (paper Table 6's shape): the port's top-k
    against dense scores and bof_tpu's, on the fused K2 + B8 path and the
    csrmm-composition path, on uniform and on Zipf-skewed documents."""
    n_docs, vocab, n_labels, density, seed, k, lb = XML_INPUTS[docs]
    a_sp, w_np, ref, port = _xml_case(ctxs, n_docs, vocab, n_labels,
                                      density, seed, False)
    _set(ctxs, max_nnzs=512)
    s, l = port_xml.xml_rank(*port, k, label_blk=lb, doc_blk=41,
                             fused=fused, ctx=ctxs[1])
    rs, rl = ref_xml.xml_rank(*ref, k, label_blk=lb, doc_blk=41, fused=fused,
                              ctx=ctxs[0])
    want = (a_sp @ w_np.T).astype(np.float32)
    got_s, got_l = s.read_all(), l.read_all()
    _check_topk(got_s, got_l, want, k)
    _labels_match_apart_from_ties(got_l, rl.read_all(), rs.read_all())
    np.testing.assert_allclose(got_s, rs.read_all(), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_xml_rank_colmajor_w_and_wide_k(ctxs, fused):
    """W stored (vocab x labels) column-major and k wider than a label
    block (the -inf pad of the composition path, the lb_max >= k clamp of
    the fused one)."""
    a_sp, w_np, ref, port = _xml_case(ctxs, 64, 40, 30, 0.15, 6, True)
    k = 9
    s, l = port_xml.xml_rank(*port, k, label_blk=4, fused=fused, ctx=ctxs[1])
    rs, rl = ref_xml.xml_rank(*ref, k, label_blk=4, fused=fused, ctx=ctxs[0])
    want = (a_sp @ w_np.T).astype(np.float32)
    _check_topk(s.read_all(), l.read_all(), want, k)
    _labels_match_apart_from_ties(l.read_all(), rl.read_all(),
                                  rs.read_all())


def test_xml_rank_fused_moves_only_the_top_k(ctxs):
    """The fused path downloads rows * k * 8 bytes a label block, and
    its in-memory twin is bof_tpu's golden model."""
    a_sp, w_np, _, port = _xml_case(ctxs, 200, 64, 50, 0.1, 9, False)
    k = 4
    _set(ctxs, max_nnzs=512)
    before = PORT_METRICS.get("xml_rank.d2h_bytes")
    s, l = port_xml.xml_rank(*port, k, label_blk=16, fused=True,
                             ctx=ctxs[1])
    assert PORT_METRICS.get("xml_rank.d2h_bytes") - before == \
        200 * k * 8 * 4  # 4 label blocks
    want_s, want_l = ref_xml.xml_rank_in_mem(a_sp, w_np, k)
    got_s, got_l = port_xml.xml_rank_in_mem(a_sp, w_np, k)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_l, want_l)
    _check_topk(s.read_all(), l.read_all(), (a_sp @ w_np.T), k)


def _band(rng, rows, rmax, vocab, lb_max, lb):
    """One fused-step band as both packages' planners build it: a padded
    ELL pair, its row counts, a (vocab, lb_max) W panel with a zero tail
    past lb, and the -inf label mask."""
    counts = rng.integers(0, rmax + 1, rows)
    counts[0] = rmax
    ja = np.zeros((rows, rmax), np.int32)
    va = np.zeros((rows, rmax), np.float32)
    for i, c in enumerate(counts):
        ja[i, :c] = rng.choice(vocab, c, replace=False)
        va[i, :c] = rng.standard_normal(c)
    panel = np.zeros((vocab, lb_max), np.float32)
    panel[:, :lb] = rng.standard_normal((vocab, lb))
    mask = np.zeros(lb_max, np.float32)
    mask[lb:] = -np.inf
    return ja, va, counts.astype(np.int32), panel, mask


@pytest.mark.parametrize("rows,rmax,vocab,lb_max,lb,k", [
    (64, 16, 300, 32, 32, 5), (40, 8, 100, 24, 3, 9), (16, 4, 50, 8, 8, 8),
    (33, 12, 90, 20, 20, 1)])
def test_topk_step_matches_reference(rows, rmax, vocab, lb_max, lb, k):
    """The fused step on one band, K2 then B8 (plain versions), against
    bof_tpu's jitted product + lax.top_k: scores within 2e-4, labels equal
    apart from near-ties; with a tail narrower than k both return the
    padded columns' -inf at the same offsets (>= lb), which _merge_topk
    drops."""
    rng = np.random.default_rng(rows + k)
    ja, va, counts, panel, mask = _band(rng, rows, rmax, vocab, lb_max, lb)
    want_s, want_l = ref_xml._topk_step(k)(jnp.asarray(panel),
                                           jnp.asarray(ja), jnp.asarray(va),
                                           jnp.asarray(mask))
    want_s, want_l = np.asarray(want_s), np.asarray(want_l)
    got_s, got_l = port_xml._topk_step(
        torch.from_numpy(panel), torch.from_numpy(ja), torch.from_numpy(va),
        torch.from_numpy(counts), torch.from_numpy(mask), k)
    got_s, got_l = got_s.numpy(), got_l.numpy()
    np.testing.assert_allclose(got_s, want_s, rtol=2e-4, atol=1e-4)
    _labels_match_apart_from_ties(got_l, want_l, want_s)
    pad = np.isneginf(want_s)
    np.testing.assert_array_equal(np.isneginf(got_s), pad)
    np.testing.assert_array_equal(got_l[pad], want_l[pad])
    assert (got_l[pad] >= lb).all()


# ------------------------------------------------------ B8, the row top-k

def _lax(x, mask, k):
    v, i = jax.lax.top_k(jnp.asarray(x) + jnp.asarray(mask)[None, :], k)
    return np.asarray(v), np.asarray(i)


def _topk_case(name):
    """(scores, mask, k) of each case the kernel must order as
    lax.top_k does."""
    rng = np.random.default_rng(len(name))
    lb_max = 64
    s = rng.standard_normal((37, lb_max)).astype(np.float32)
    mask = np.zeros(lb_max, np.float32)
    if name == "ties":
        s = np.round(s * 2) / 2  # many equal values in a row
        return s, mask, 10
    if name == "all_equal":
        return np.full_like(s, 0.25), mask, 7
    if name == "neg_inf_tail":  # the tail wider than the real labels
        mask[5:] = -np.inf
        return s, mask, 12
    if name == "k1":
        return s, mask, 1
    if name == "k_eq_lb":
        s[:, 3] = s[:, 9]
        mask[40:] = -np.inf
        return s, mask, lb_max
    if name == "non_finite":
        s[0, 3], s[1, 7], s[2, :4] = np.nan, -np.nan, np.inf
        s[3, 5], s[4, 6] = -np.inf, np.nan
        s[5, :3] = [0.0, -0.0, 0.0]
        s[6, :] = -0.0
        return s, mask, 9
    raise KeyError(name)


@pytest.mark.parametrize("case", ["ties", "all_equal", "neg_inf_tail", "k1",
                                  "k_eq_lb", "non_finite"])
def test_row_topk_plain_is_lax_top_k(case):
    """B8's plain version (what the CPU path runs and what the kernel is
    held to on the card) gives jax.lax.top_k's values and columns bit for
    bit: ties by the lower column, -inf tails, k = 1 and k = lb, and NaN
    and signed zeros in XLA's total order (+NaN first, -NaN last, +0
    before -0)."""
    s, mask, k = _topk_case(case)
    want_v, want_i = _lax(s, mask, k)
    before = topk_cuda.row_topk.launches
    got_v, got_i = topk_cuda.row_topk(torch.from_numpy(s),
                                      torch.from_numpy(mask), k)
    assert topk_cuda.row_topk.launches == before, \
        "CPU tensors take the plain version"
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  want_v.view(np.int32))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32


def test_row_topk_without_mask_and_its_checks():
    rng = np.random.default_rng(1)
    s = rng.standard_normal((5, 11)).astype(np.float32)
    got_v, got_i = topk_cuda.row_topk(torch.from_numpy(s), None, 3)
    want_v, want_i = _lax(s, np.zeros(11, np.float32), 3)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    t = torch.from_numpy(s)
    for bad_k in (0, 12):
        with pytest.raises(ValueError, match="out of range"):
            topk_cuda.row_topk(t, None, bad_k)
    with pytest.raises(ValueError, match="fp32"):
        topk_cuda.row_topk(t.double(), None, 2)
    with pytest.raises(ValueError, match="mask"):
        topk_cuda.row_topk(t, torch.zeros(10), 2)
    with pytest.raises(ValueError, match="contiguous"):
        topk_cuda.row_topk(t.T, None, 2)


def test_row_topk_wrapper_knows_the_kernels_smem_width():
    """The wrapper's `TOPK_SMEM_COLS` and `TOPK_REG_COLS` (which variant a
    launch counts as) are the CUDA source's."""
    with open(os.path.join(REPO, "bof_tpu_torch", "csrc", "topk.cu")) as f:
        src = f.read()
    for name in ("TOPK_SMEM_COLS", "TOPK_REG_COLS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert int(m.group(1)) == getattr(topk_cuda, name), name
    assert [topk_cuda.topk_variant(c) for c in (1, 1024, 1025, 4096, 4097)] \
        == ["reg", "reg", "smem", "smem", "l2"]


# ------------------------------------------------------- mesh= paths

def test_mesh_paths_raise_naming_a14(ctxs):
    """The three applications' mesh= paths on a world of one CPU rank (a
    1 x 1 mesh) against bof_tpu's on make_mesh(1): singular values rtol
    1e-4, XML scores by `_check_topk`, topic labels on all but 1 % of the
    documents (tests/test_torch_parallel_apps.py runs them on 4 ranks)."""
    from bof_tpu.parallel import make_mesh as ref_make_mesh
    from torch_dist_pool import one_rank_world
    a_sp = _random_a(120, 40, 0.2)
    A_ref, A = _csr(ctxs, a_sp)
    w_np = np.random.default_rng(3).standard_normal((6, 40)).astype(
        np.float32)
    W = bof_tpu_torch.mem_array((6, 40), np.float32, ctx=ctxs[1], data=w_np)
    ref_mesh = ref_make_mesh(1)
    with one_rank_world() as mesh:
        sigma, _ = port_eig.block_lanczos_svd(A, 2, mesh=mesh, ctx=ctxs[1])
        s, l = port_xml.xml_rank(A, W, 2, mesh=mesh, ctx=ctxs[1])
        tw, labels = port_tm.topic_model(A, 2, proj_dim=8, mesh=mesh,
                                         ctx=ctxs[1])
    want_s, _ = ref_eig.block_lanczos_svd(A_ref, 2, mesh=ref_mesh,
                                          ctx=ctxs[0])
    np.testing.assert_allclose(sigma, want_s, rtol=1e-4)
    _check_topk(s.read_all(), l.read_all(),
                np.asarray(a_sp @ w_np.T, np.float32), 2)
    _, want_l = ref_tm.topic_model(A_ref, 2, proj_dim=8, mesh=ref_mesh,
                                   ctx=ctxs[0])
    assert tw.shape == (2, 40) and (labels != want_l).mean() <= 0.01


# ---------------------------------------------------------------- drivers

def _run_driver(mod, *args, scratch):
    argv = [str(a) for a in args] + ["--device", "cpu", "--scratch", scratch]
    return importlib.import_module(f"bof_tpu_torch.drivers.{mod}").main(argv)


@pytest.fixture
def corpus(tmp_path):
    """A tiny CSR file triplet from the port's sparse_create, and its
    scipy twin: (prefix, scipy matrix, scratch dir)."""
    from bof_tpu_torch.drivers import sparse_create
    from bof_tpu_torch.drivers.in_mem_sparse import load_csr
    prefix = str(tmp_path / "A")
    m, k = 240, 90
    sparse_create.main([prefix, str(m), str(k), "6", "--seed", "4"])
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    return prefix, load_csr(prefix, m, k), str(scratch)


def test_eigensolver_driver(corpus, tmp_path, capsys):
    """Lanczos (one pass, and with --two-pass) and power through the CLI
    against scipy's svds; --state is consumed on convergence; --sharded on
    a world of one rank."""
    prefix, a_sp, scratch = corpus
    m, k = a_sp.shape
    want = _svds(a_sp, 4)
    state = str(tmp_path / "lz.npz")
    sigma, v = _run_driver("eigensolver", prefix, m, k, 4, "--iters", 20,
                           "--state", state, scratch=scratch)
    assert "singular values:" in capsys.readouterr().out
    np.testing.assert_allclose(sigma, want, rtol=1e-3)
    assert v.shape == (k, 4) and not os.path.exists(state)
    for extra in (["--two-pass"], ["--solver", "power", "--iters", 200]):
        sig, _ = _run_driver("eigensolver", prefix, m, k, 4, *extra,
                             scratch=scratch)
        np.testing.assert_allclose(sig, want, rtol=1e-3)
    from torch_dist_pool import one_rank_world
    with one_rank_world():
        sig, _ = _run_driver("eigensolver", prefix, m, k, 4, "--iters", 20,
                             "--sharded", scratch=scratch)
    np.testing.assert_allclose(sig, want, rtol=1e-3)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_xml_rank_driver(corpus, tmp_path, capsys, fused):
    """W from a file, the top-k written to --scores/--labels, against
    dense scores; --sharded on a world of one rank."""
    prefix, a_sp, scratch = corpus
    docs, vocab = a_sp.shape
    n_labels, k = 37, 5
    w_np = np.random.default_rng(2).standard_normal(
        (n_labels, vocab)).astype(np.float32)
    w_path = str(tmp_path / "W.bin")
    w_np.tofile(w_path)
    s_path, l_path = str(tmp_path / "s.bin"), str(tmp_path / "l.bin")
    s, l = _run_driver("xml_rank", prefix, docs, vocab, w_path, n_labels, k,
                       "--scores", s_path, "--labels", l_path, "--label-blk",
                       16, "--fused", fused, scratch=scratch)
    assert "checksum" in capsys.readouterr().out
    _check_topk(s, l, np.asarray(a_sp @ w_np.T, np.float32), k)
    np.testing.assert_array_equal(
        np.fromfile(s_path, np.float32).reshape(docs, k), s)
    np.testing.assert_array_equal(
        np.fromfile(l_path, np.int32).reshape(docs, k), l)
    from torch_dist_pool import one_rank_world
    with one_rank_world():
        s2, l2 = _run_driver("xml_rank", prefix, docs, vocab, w_path,
                             n_labels, k, "--label-blk", 16, "--fused",
                             fused, "--sharded", scratch=scratch)
    _check_topk(s2, l2, np.asarray(a_sp @ w_np.T, np.float32), k)
    np.testing.assert_allclose(s2, s, rtol=2e-4, atol=1e-4)


def test_topic_model_driver(corpus, tmp_path, capsys):
    """The ISLE mode through the CLI with --out and --state: the returned
    topic-word matrix is the row-normalized float64 one_hot(labels)^T A
    (rows of non-positive mass zero), the file holds it, the state is
    consumed; --sharded on a world of one rank gives a model of the same
    form."""
    prefix, a_sp, scratch = corpus
    docs, vocab = a_sp.shape
    out = str(tmp_path / "topics.bin")
    state = str(tmp_path / "km.npz")
    tw, labels = _run_driver("topic_model", prefix, docs, vocab, 6,
                             "--proj-dim", 8, "--iters", 3, "--sample-rate",
                             0.5, "--out", out, "--state", state,
                             scratch=scratch)
    assert "label-histogram" in capsys.readouterr().out
    assert tw.shape == (6, vocab) and labels.shape == (docs,)
    assert labels.min() >= 0 and labels.max() < 6
    np.testing.assert_array_equal(
        np.fromfile(out, np.float32).reshape(6, vocab), tw)
    onehot = np.zeros((docs, 6))
    onehot[np.arange(docs), labels] = 1.0
    t64 = np.asarray((a_sp.T.astype(np.float64) @ onehot).T)
    norm = t64.sum(1, keepdims=True)
    want = np.where(norm > 0, t64 / np.where(norm > 0, norm, 1.0), 0.0)
    np.testing.assert_allclose(tw, want, rtol=1e-4, atol=1e-6)
    assert not os.path.exists(state)
    from torch_dist_pool import one_rank_world
    with one_rank_world():
        tw2, labels2 = _run_driver("topic_model", prefix, docs, vocab, 6,
                                   "--proj-dim", 8, "--iters", 3,
                                   "--sample-rate", 0.5, "--sharded",
                                   scratch=scratch)
    onehot = np.zeros((docs, 6))
    onehot[np.arange(docs), labels2] = 1.0
    t64 = np.asarray((a_sp.T.astype(np.float64) @ onehot).T)
    norm = t64.sum(1, keepdims=True)
    want = np.where(norm > 0, t64 / np.where(norm > 0, norm, 1.0), 0.0)
    np.testing.assert_allclose(tw2, want, rtol=1e-4, atol=1e-6)
