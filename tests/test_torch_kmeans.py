"""The port's out-of-core k-means against bof_tpu's, on the same points.

Points and centers come from a seeded numpy generator and go to both
packages as numpy arrays.  The block step (B7's plain version here, on the
CPU) is held to bof_tpu's `_jit_steps()` step: labels equal, mind and sums
within 1e-5 relative, counts equal.  Whole iterations and fits are held to
bof_tpu's within 1e-4 (centers and inertia): both sum fp32 values in
different orders.  float64 points take the same exact host step in both,
bit for bit.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bof_tpu
import bof_tpu_torch
from bof_tpu.ops import kmeans as ref_km
from bof_tpu_torch.ops import kmeans as port_km


def blobs(rng, n, d, k, spread=0.05):
    centers = rng.standard_normal((k, d)).astype(np.float32) * 3
    labels = rng.integers(0, k, n)
    pts = centers[labels] + spread * rng.standard_normal((n, d)).astype(
        np.float32)
    return pts.astype(np.float32), centers


@pytest.fixture
def ctxs(tmp_path):
    """(bof_tpu context, port context on the CPU), one configuration."""
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


def _arrays(ctxs, pts):
    ref, port = ctxs
    n, d = pts.shape
    return (bof_tpu.mem_array((n, d), pts.dtype, data=pts, ctx=ref),
            bof_tpu_torch.mem_array((n, d), pts.dtype, data=pts, ctx=port))


@pytest.mark.parametrize("bn,d,k", [(257, 16, 5), (1000, 33, 7), (1, 8, 3),
                                    (600, 4, 1)])
def test_block_step_matches_reference(bn, d, k):
    rng = np.random.default_rng(bn + d + k)
    p, _ = blobs(rng, bn, d, k, spread=0.5)
    c = p[rng.integers(0, bn, k)] + 0.1 * rng.standard_normal(
        (k, d)).astype(np.float32)
    cn = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
    r_lab, r_mind, r_sums, r_counts = ref_km._jit_steps()(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(cn),
        jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32),
        n_centers=k, prec="highest")
    sums = torch.zeros((k, d))
    counts = torch.zeros(k, dtype=torch.int32)
    before = (port_km.lloyd_assign.launches,
              port_km.lloyd_accumulate.launches)
    labels, mind = port_km.lloyd_block(torch.from_numpy(p),
                                       torch.from_numpy(c),
                                       torch.from_numpy(cn), sums, counts)
    assert (port_km.lloyd_assign.launches,
            port_km.lloyd_accumulate.launches) == before, \
        "CPU tensors take the plain version"
    plain = (torch.zeros((k, d)), torch.zeros(k, dtype=torch.int32))
    p_lab, p_mind = port_km.lloyd_block_ref(
        torch.from_numpy(p), torch.from_numpy(c), torch.from_numpy(cn),
        *plain)
    assert torch.equal(p_lab, labels) and torch.equal(p_mind, mind)
    assert torch.equal(plain[0], sums) and torch.equal(plain[1], counts)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(r_lab))
    scale = (p.astype(np.float64) ** 2).sum(1) + float(cn.max())
    assert (np.abs(mind.numpy() - np.asarray(r_mind)) <= 1e-5 * scale).all()
    np.testing.assert_array_equal(counts.numpy().astype(np.float32),
                                  np.asarray(r_counts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(r_sums), rtol=1e-5,
                               atol=1e-5 * float(np.abs(p).sum(0).max()))


def test_block_step_ties_take_the_first_index():
    """Duplicated centers: the first index wins, as jnp.argmin."""
    rng = np.random.default_rng(8)
    c = rng.standard_normal((6, 5)).astype(np.float32)
    c[4] = c[1]
    p = torch.from_numpy(c[[1, 4, 0]].copy())
    ct = torch.from_numpy(c)
    labels, _ = port_km.lloyd_assign(p, ct, (ct * ct).sum(1))
    assert labels.tolist() == [1, 1, 0]
    r_lab = ref_km._jit_steps()(
        jnp.asarray(p.numpy()), jnp.asarray(c), jnp.asarray((c * c).sum(1)),
        jnp.zeros((6, 5), jnp.float32), jnp.zeros((6,), jnp.float32),
        n_centers=6, prec="highest")[0]
    assert np.asarray(r_lab).tolist() == [1, 1, 0]


def test_lloyds_iter_matches_reference(ctxs):
    rng = np.random.default_rng(0)
    pts, _ = blobs(rng, 2000, 16, 5)
    P_ref, P_port = _arrays(ctxs, pts)
    c0 = pts[:5].copy()
    want = ref_km.lloyds_iter(P_ref, c0, blk_rows=257, ctx=ctxs[0])
    got = port_km.lloyds_iter(P_port, c0, blk_rows=257, ctx=ctxs[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].dtype == np.float32 and got[2].dtype == np.float32
    golden, g_inertia = ref_km.kmeans_in_mem(pts, c0, n_iters=1)
    np.testing.assert_allclose(got[0], golden, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], g_inertia, rtol=1e-3)


@pytest.mark.parametrize("init,n_init", [("kmeans++", 1), ("random", 2)])
def test_kmeans_fit_matches_reference(ctxs, init, n_init):
    """Same seed, so the same k-means++ (or random) sample in both."""
    rng = np.random.default_rng(1)
    pts, _ = blobs(rng, 3000, 8, 6, spread=0.1)
    P_ref, P_port = _arrays(ctxs, pts)
    kw = dict(n_iters=5, seed=3, init=init, n_init=n_init)
    c_ref, i_ref = ref_km.kmeans_fit(P_ref, 6, ctx=ctxs[0], **kw)
    c_port, i_port = port_km.kmeans_fit(P_port, 6, ctx=ctxs[1], **kw)
    np.testing.assert_allclose(c_port, c_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(i_port, i_ref, rtol=1e-4)


def test_sampling_helpers_are_the_reference_draws(ctxs):
    rng = np.random.default_rng(2)
    pts, _ = blobs(rng, 5000, 4, 3)
    P_ref, P_port = _arrays(ctxs, pts)
    for s in (10, 700, 5000):
        np.testing.assert_array_equal(
            port_km._sample_indices(5000, s, np.random.default_rng(s)),
            ref_km._sample_indices(5000, s, np.random.default_rng(s)))
    idx = np.array([0, 1, 2, 7, 8, 4000, 4999])
    np.testing.assert_array_equal(port_km.gather_rows(P_port, idx),
                                  ref_km.gather_rows(P_ref, idx))
    for cap in (512, 4500):  # one row block, and several
        np.testing.assert_array_equal(
            port_km._kmeanspp_sample(P_port, 9, np.random.default_rng(5),
                                     sample_cap=cap),
            ref_km._kmeanspp_sample(P_ref, 9, np.random.default_rng(5),
                                    sample_cap=cap))
    for args in ((10 ** 6, 128, 1024, 12 << 30), (3000, 6, 5, 1 << 10),
                 (100, 12, 5, 12 << 30, 8)):
        assert port_km._lloyd_blk_rows(*args) == ref_km._lloyd_blk_rows(*args)


def test_resident_tier_matches_streaming(ctxs):
    """The fit with the panel uploaded once against the per-pass
    streaming fit (the budget denies residency): the same labels and
    centers (tests/test_kmeans.py:80)."""
    port = ctxs[1]
    rng = np.random.default_rng(3)
    n, d, k = 3000, 6, 5
    pts, _ = blobs(rng, n, d, k)
    P = bof_tpu_torch.mem_array((n, d), np.float32, data=pts, ctx=port)
    labs = [bof_tpu_torch.mem_array((n,), np.int32, ctx=port)
            for _ in range(2)]
    from bof_tpu_torch.utils import METRICS
    METRICS.reset()
    c_a, i_a = port_km.kmeans_fit(P, k, n_iters=5, seed=7,
                                  labels_out=labs[0], ctx=port)
    assert METRICS.get("kmeans.h2d_bytes") == n * d * 4, "one upload"
    old = port.config.hbm_budget
    port.config.hbm_budget = 1 << 10
    METRICS.reset()
    try:
        c_b, i_b = port_km.kmeans_fit(P, k, n_iters=5, seed=7,
                                      labels_out=labs[1], ctx=port)
    finally:
        port.config.hbm_budget = old
    assert METRICS.get("kmeans.h2d_bytes") >= 5 * n * d * 4, "a pass each"
    np.testing.assert_allclose(c_a, c_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(i_a, i_b, rtol=1e-3)
    np.testing.assert_array_equal(labs[0].read_all(), labs[1].read_all())


def test_empty_cluster_keeps_center(ctxs):
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((100, 4)).astype(np.float32)
    P_ref, P_port = _arrays(ctxs, pts)
    far = np.full((1, 4), 1e6, np.float32)  # never assigned
    c0 = np.concatenate([pts[:2], far])
    centers, _, counts = port_km.lloyds_iter(P_port, c0, ctx=ctxs[1])
    assert counts[2] == 0
    np.testing.assert_array_equal(centers[2], far[0])
    want, _, _ = ref_km.lloyds_iter(P_ref, c0, ctx=ctxs[0])
    np.testing.assert_allclose(centers, want, rtol=1e-5, atol=1e-6)


def test_fp64_is_the_reference_host_step_bit_for_bit(ctxs):
    """float64 points take bof_tpu's exact numpy host step: centers,
    inertia, counts and labels identical to bof_tpu's."""
    rng = np.random.default_rng(5)
    n, d, k = 1500, 12, 5
    pts = rng.standard_normal((n, d))
    P_ref, P_port = _arrays(ctxs, pts)
    L_ref = bof_tpu.mem_array((n,), np.int32, ctx=ctxs[0])
    L_port = bof_tpu_torch.mem_array((n,), np.int32, ctx=ctxs[1])
    c0 = pts[:k].copy()
    want = ref_km.lloyds_iter(P_ref, c0, labels_out=L_ref, blk_rows=211,
                              ctx=ctxs[0])
    got = port_km.lloyds_iter(P_port, c0, labels_out=L_port, blk_rows=211,
                              ctx=ctxs[1])
    assert got[0].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(L_port.read_all(), L_ref.read_all())
    c_ref, i_ref = ref_km.kmeans_fit(P_ref, k, n_iters=4, seed=1,
                                     ctx=ctxs[0])
    c_port, i_port = port_km.kmeans_fit(P_port, k, n_iters=4, seed=1,
                                        ctx=ctxs[1])
    np.testing.assert_array_equal(c_port, c_ref)
    assert i_port == i_ref


def test_labels_written(ctxs):
    rng = np.random.default_rng(6)
    n, d, k = 1200, 8, 4
    pts, _ = blobs(rng, n, d, k)
    _, P = _arrays(ctxs, pts)
    L = bof_tpu_torch.mem_array((n,), np.int32, ctx=ctxs[1])
    c0 = pts[:k].copy()
    port_km.lloyds_iter(P, c0, labels_out=L, blk_rows=333, ctx=ctxs[1])
    d2 = ((pts[:, None, :].astype(np.float64)
           - c0[None, :, :].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(L.read_all(), d2.argmin(1))
    L2 = bof_tpu_torch.mem_array((n,), np.int32, ctx=ctxs[1])
    centers, _ = port_km.kmeans_fit(P, k, n_iters=3, seed=2, labels_out=L2,
                                    ctx=ctxs[1])
    d2 = ((pts[:, None, :].astype(np.float64)
           - centers[None, :, :].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(L2.read_all(), d2.argmin(1))


def test_reference_checkpoint_resumes_in_the_port(ctxs, tmp_path,
                                                  monkeypatch):
    """A fit of bof_tpu's interrupted after its third iteration leaves its
    state file; the port's kmeans_fit resumes from it and ends where an
    uninterrupted fit ends (the port's own, and bof_tpu's)."""
    rng = np.random.default_rng(7)
    pts, _ = blobs(rng, 2000, 6, 4)
    P_ref, P_port = _arrays(ctxs, pts)
    state = str(tmp_path / "km_state.npz")
    kw = dict(n_iters=6, seed=5, tol=-1.0)
    want_port = port_km.kmeans_fit(P_port, 4, ctx=ctxs[1], **kw)
    want_ref = ref_km.kmeans_fit(P_ref, 4, ctx=ctxs[0], **kw)

    calls = []
    real = ref_km._lloyds_iter_device

    def crash_on_fourth(*a, **k):
        calls.append(1)
        if len(calls) == 4:
            raise KeyboardInterrupt("simulated crash")
        return real(*a, **k)
    monkeypatch.setattr(ref_km, "_lloyds_iter_device", crash_on_fourth)
    with pytest.raises(KeyboardInterrupt):
        ref_km.kmeans_fit(P_ref, 4, state_path=state, ctx=ctxs[0], **kw)
    with np.load(state) as st:
        assert int(st["it"]) == 2
    got = port_km.kmeans_fit(P_port, 4, state_path=state, ctx=ctxs[1], **kw)
    assert not os.path.exists(state)
    np.testing.assert_allclose(got[0], want_port[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], want_ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], want_ref[1], rtol=1e-4)


def _near_ties_only(p, c, got, want):
    """Where two label vectors differ, the float64 partial distances of the
    two centers are within 1e-5 * (|p|^2 + max|c|^2) of each other: a
    near-tie that fp32-class arithmetic may break either way."""
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return True
    p64, c64 = p[diff].astype(np.float64), c.astype(np.float64)
    pd = (c64 * c64).sum(1)[None, :] - 2.0 * p64 @ c64.T
    rows = np.arange(diff.size)
    gap = np.abs(pd[rows, got[diff]] - pd[rows, want[diff]])
    scale = (p64 * p64).sum(1) + (c64 * c64).sum(1).max()
    return bool((gap <= 1e-5 * scale).all())


@pytest.mark.parametrize("bn,d,k", [(257, 16, 5), (1000, 33, 7), (1, 8, 3),
                                    (600, 4, 1), (3000, 130, 300)])
def test_tf32x3_assign_emulation_matches_plain_and_reference(bn, d, k):
    """The plain 3xTF32 emulation of lloyd_assign's arithmetic (d = 33 and
    130 not multiples of 4, k not a multiple of the 256-center tile)
    against lloyd_assign_ref and bof_tpu's block step ('highest'): labels
    equal but at near-ties, mind within 1e-5 * (|p|^2 + max|c|^2), the
    tolerance chip_smoke.py holds the kernel to.  Its lo terms are in: its
    mind is within 1e-6 * that scale of float64's, where one TF32 pass
    (hi alone) is not."""
    rng = np.random.default_rng(bn * 7 + d + k)
    p, _ = blobs(rng, bn, d, k, spread=0.5)
    c = p[rng.integers(0, bn, k)] + 0.1 * rng.standard_normal(
        (k, d)).astype(np.float32)
    cn = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
    pt, ct, cnt = (torch.from_numpy(x) for x in (p, c, cn))
    e_lab, e_mind = port_km.lloyd_assign_tf32x3_ref(pt, ct, cnt)
    assert e_lab.dtype == torch.int32 and e_mind.dtype == torch.float32
    p_lab, p_mind = port_km.lloyd_assign_ref(pt, ct, cnt)
    r_lab, r_mind = ref_km._jit_steps()(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(cn),
        jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32),
        n_centers=k, prec="highest")[:2]
    scale = (p.astype(np.float64) ** 2).sum(1) + float(cn.max())
    for lab, mind in ((p_lab.numpy(), p_mind.numpy()),
                      (np.asarray(r_lab), np.asarray(r_mind))):
        assert _near_ties_only(p, c, e_lab.numpy(), lab)
        assert (np.abs(e_mind.numpy() - mind) <= 1e-5 * scale).all()
    pd64 = cn.astype(np.float64)[None, :] - 2.0 * (
        p.astype(np.float64) @ c.astype(np.float64).T)
    mind64 = pd64[np.arange(bn), e_lab.numpy()]
    assert (np.abs(e_mind.numpy() - mind64) <= 1e-6 * scale).all()
    hi_p, hi_c = (port_km.tf32_truncate(x).double().numpy() for x in (pt, ct))
    one_pass = cn.astype(np.float64)[None, :] - 2.0 * hi_p @ hi_c.T
    assert (np.abs(one_pass - pd64).max(1) > 1e-6 * scale).any()


@pytest.mark.parametrize("d,aligned,want", [
    (128, (True, True), {"p_lo": 1000, "c_lo": 7}),
    (33, (True, True), {"p_x": 1000, "p_lo": 1000, "c_x": 7, "c_lo": 7}),
    (128, (False, True), {"p_x": 1000, "p_lo": 1000, "c_lo": 7}),
    (128, (True, False), {"p_lo": 1000, "c_x": 7, "c_lo": 7}),
])
def test_lloyd_workspace_rows(d, aligned, want):
    """lloyd_assign's split pass writes lo of the points and the centers,
    and a K-major copy of either only where TMA cannot read it in place
    (d not a multiple of 4 floats, a base not 16-byte aligned); rows of d
    rounded up to 32 floats (128-byte lines)."""
    assert port_km.lloyd_workspace(1000, 7, d, aligned=aligned) == want
    assert [port_km.tf32_ldw(x) for x in (33, 128, 130)] == [64, 128, 160]


def test_kmeans_in_mem_is_the_reference_golden_model():
    rng = np.random.default_rng(9)
    pts, _ = blobs(rng, 300, 5, 3)
    c0 = pts[:3].copy()
    got = port_km.kmeans_in_mem(pts, c0, n_iters=3)
    want = ref_km.kmeans_in_mem(pts, c0, n_iters=3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("bn,d,k,skew", [(1000, 33, 7, None),
                                         (1, 8, 3, None),
                                         (2500, 16, 9, "one"),
                                         (2049, 12, 10, "half")])
def test_ordered_accumulate_matches_reference(bn, d, k, skew):
    """The accumulate kernel's order-faithful plain version against
    index_add_ (`lloyd_accumulate_ref`) and bof_tpu's block step on its
    labels: sums within 1e-5 relative, counts exact; also with every point
    in one center ("one") and with half the centers empty ("half"), which
    far centers force on bof_tpu's argmin."""
    rng = np.random.default_rng(bn + d + k)
    p, _ = blobs(rng, bn, d, k, spread=0.5)
    c = p[rng.integers(0, bn, k)] + 0.1 * rng.standard_normal(
        (k, d)).astype(np.float32)
    if skew == "one":
        c[:] = 1e3
        c[k // 2] = p.mean(0)
    elif skew == "half":
        c[1::2] = 1e3
    cn = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
    r_lab, _, r_sums, r_counts = ref_km._jit_steps()(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(cn),
        jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32),
        n_centers=k, prec="highest")
    labels = torch.from_numpy(np.asarray(r_lab).astype(np.int32))
    if skew == "one":
        assert (labels == k // 2).all()
    elif skew == "half":
        assert (labels % 2 == 0).all()
    pt = torch.from_numpy(p)
    got = (torch.zeros((k, d)), torch.zeros(k, dtype=torch.int32))
    port_km.lloyd_accumulate_ordered_ref(pt, labels, *got, budget=1 << 12)
    want = (torch.zeros((k, d)), torch.zeros(k, dtype=torch.int32))
    port_km.lloyd_accumulate_ref(pt, labels, *want)
    assert torch.equal(got[1], want[1])
    np.testing.assert_array_equal(got[1].numpy().astype(np.float32),
                                  np.asarray(r_counts))
    atol = 1e-5 * float(np.abs(p).sum(0).max())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(r_sums), rtol=1e-5,
                               atol=atol)
    # each center's sum is its rows added one by one in index order
    for j in range(k):
        acc = np.zeros(d, np.float32)
        for row in p[np.asarray(r_lab) == j]:
            acc = acc + row
        np.testing.assert_array_equal(got[0][j].numpy(), acc)


def test_wrappers_check_their_inputs():
    p = torch.zeros((4, 3))
    c = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="fp32"):
        port_km.lloyd_assign(p.double(), c, torch.zeros(2))
    with pytest.raises(ValueError, match="match"):
        port_km.lloyd_assign(p, torch.zeros((2, 4)), torch.zeros(2))
    with pytest.raises(ValueError, match="int32"):
        port_km.lloyd_accumulate(p, torch.zeros(4, dtype=torch.int64),
                                 torch.zeros((2, 3)),
                                 torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="match"):
        port_km.lloyd_accumulate(p, torch.zeros(4, dtype=torch.int32),
                                 torch.zeros((2, 4)),
                                 torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        port_km.lloyd_accumulate(p, torch.zeros(4, dtype=torch.int32),
                                 torch.zeros((2, 3)),
                                 torch.zeros(2, dtype=torch.int64))


def test_assign_variant_tool_edits_apply_to_the_committed_kernel(tmp_path):
    """tools/torch_b7_assign_variants.py times textual variants of
    csrc/kmeans.cu (the measurements PERF.md cites): each edit must still
    find its text in the committed source, once, and the first design comes
    from the file it is given."""
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "b7_assign_variants",
        os.path.join(root, "tools", "torch_b7_assign_variants.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(tool.CSRC, "kmeans.cu")) as f:
        src = f.read()
    first = tmp_path / "first.cu"
    first.write_text("// the first design\n")
    variants = tool._variants(src, tool.NAMES, str(first))
    assert variants["committed"] == src
    assert variants[tool.FIRST] == "// the first design\n"
    assert set(variants) == set(tool.NAMES)
    assert len(set(variants.values())) == len(tool.NAMES)
