"""Randomized differential fuzzing of the port's planners against bof_tpu,
case for case after tests/test_fuzz.py and with its case counts: seeded
random shapes, leading dimensions (ld-padded sub-matrices), orders,
transposes, alpha/beta and block sizes through gemm (fp32 and float64)
and csrmm (fp32); tests/test_torch_fuzz_apps.py holds the rest of
test_fuzz.py (csrmm float64, xml_rank, the float64 Lloyd step, the
parallel host sort) and the sharded float64 gemm.  Each case runs on both packages with the same inputs
and holds the port to float64 numpy/scipy within bof_tpu's tolerance and
to bof_tpu's own output (fp32 within 5e-4 of the larger of max|C| and 1;
float64 within bof_tpu's 1e-12 scaled bound; the host paths bit for
bit)."""
import os

import numpy as np
import pytest
import scipy.sparse as sps

from torch_pair import BOTH, REF

# deeper sweeps on demand: BOF_FUZZ_CASES=100 python -m pytest tests/test_torch_fuzz.py
_N = int(os.environ.get("BOF_FUZZ_CASES", "0"))


@pytest.fixture
def contexts(tmp_path):
    ctxs = {pk.name: pk.context(tmp_path / f"{pk.name}_scratch")
            for pk in BOTH}
    yield ctxs
    for c in ctxs.values():
        c.destroy()


def padded_operand(pk, ctx, rng, rows, cols, order, dtype, scale_rows=False):
    """A logical (rows, cols) array stored as an ld-padded sub-matrix of a
    bigger parent at a random interior offset (`rng` draws the same
    numbers for both packages)."""
    lines, width = (rows, cols) if order == "R" else (cols, rows)
    pad = int(rng.integers(0, 7))
    off_lines = int(rng.integers(0, 3))
    off_in = int(rng.integers(0, pad + 1))
    ld = width + pad
    it = np.dtype(dtype).itemsize
    parent = pk.bt.mem_array(((lines + off_lines) * ld,), dtype, ctx=ctx,
                             data=rng.standard_normal(
                                 (lines + off_lines) * ld).astype(dtype))
    arr = pk.bt.FlashArray(parent.store, (rows, cols), dtype, order,
                           offset=(off_lines * ld + off_in) * it, ld=ld,
                           ctx=ctx)
    data = rng.standard_normal((rows, cols))
    if scale_rows:  # per-row decade swings
        data = data * 10.0 ** rng.uniform(-8, 8, (rows, 1))
    data = data.astype(dtype)
    arr.write_block(0, data)
    return arr, data


def gemm_case(pk, ctx, seed, dtype, dims, blks, scale_rows, gemm=None):
    rng = np.random.default_rng(seed)
    m, n, k = (int(rng.integers(3, dims)) for _ in range(3))
    ta, tb = bool(rng.integers(2)), bool(rng.integers(2))
    orders = [("R", "C")[rng.integers(2)] for _ in range(3)]
    alpha = float(rng.uniform(-2, 2))
    beta = float(rng.choice([0.0, 1.0, rng.uniform(-1, 1)]))
    blk = int(rng.choice(blks))
    A, a_np = padded_operand(pk, ctx, rng, *((k, m) if ta else (m, k)),
                             orders[0], dtype, scale_rows)
    B, b_np = padded_operand(pk, ctx, rng, *((n, k) if tb else (k, n)),
                             orders[1], dtype, scale_rows)
    C, c_np = padded_operand(pk, ctx, rng, m, n, orders[2], dtype,
                             scale_rows)
    (gemm or pk.mod("ops").gemm)(
        A, B, C, alpha=alpha, beta=beta, transa="T" if ta else "N",
        transb="T" if tb else "N", blk=blk, ctx=ctx)
    opa = (a_np.T if ta else a_np).astype(np.float64)
    opb = (b_np.T if tb else b_np).astype(np.float64)
    want = alpha * (opa @ opb) + beta * c_np.astype(np.float64)
    tag = (f"m{m} n{n} k{k} ta{ta} tb{tb} orders{orders} alpha{alpha:.3f} "
           f"beta{beta:.3f} blk{blk}")
    return C.read_block(0, m, 0, n).astype(np.float64), want, opa, opb, k, tag


@pytest.mark.parametrize("case", range(_N or 10))
def test_gemm_fuzz(case, contexts):
    (ref, *_), (got, want, _, _, _, tag) = (
        gemm_case(pk, contexts[pk.name], 1000 + case, np.float32, 150,
                  [16, 32, 64, 128], False) for pk in BOTH)
    denom = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) / denom < 5e-4, tag
    assert float(np.abs(got - ref).max()) / denom < 5e-4, tag


def check_gemm64(ref, got, want, opa, opb, k, tag):
    """Within 1e-12 of numpy and of bof_tpu, scaled by k and each row's
    and column's largest magnitudes (bof_tpu's bound, which leaves
    beta * C out of the scale: C's per-row swings make beta * C up to
    10^16 times the product, so beta * C must join the finished product
    once, as bof_tpu's gemm64 adds it)."""
    scale = np.maximum(np.abs(opa).max(axis=1)[:, None]
                       * np.abs(opb).max(axis=0)[None, :] * k, 1e-300)
    for other in (want, ref):
        err = float((np.abs(got - other) / scale).max())
        assert err < 1e-12, f"{tag} err{err:.2e}"


@pytest.mark.parametrize("case", range(_N or 8))
def test_gemm64_fuzz(case, contexts):
    """float64: bof_tpu runs its Ozaki slices ('sliced'), the port K1
    'f64''s plain version."""
    contexts[REF.name].config.fp64_device = "sliced"
    (ref, *_), got = (
        gemm_case(pk, contexts[pk.name], 7000 + case, np.float64, 120,
                  [16, 32, 64], True) for pk in BOTH)
    check_gemm64(ref, *got)


def csrmm_case(pk, ctx, seed, case, dtype):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(10, 400 if dtype == np.float32 else 300))
    k = int(rng.integers(10, 300 if dtype == np.float32 else 250))
    n = int(rng.integers(2, 100 if dtype == np.float32 else 60))
    density = float(rng.uniform(0.005 if dtype == np.float32 else 0.01,
                                0.15))
    alpha = float(rng.uniform(-2, 2))
    beta = float(rng.choice([0.0, rng.uniform(-1, 1)]))
    transa = "T" if rng.integers(2) else "N"
    order_b = ("R", "C")[rng.integers(2)]
    if dtype == np.float32:
        order_c = ("R", "C")[rng.integers(2)]
        ctx.config.max_nnzs = int(rng.choice([256, 1024, 1 << 20]))
        ctx.config.csrmm_cblk_size = int(rng.choice([16, 64, 4096]))
    else:
        order_c = "R"
        ctx.config.max_nnzs = int(rng.choice([256, 1 << 20]))
    ctx.config.sparse_compute = str(rng.choice(["host", "device", "auto"]))
    a_sp = sps.random(m, k, density=density, format="csr", dtype=dtype,
                      random_state=np.random.RandomState(case))
    if dtype == np.float64:  # magnitudes fp32 would lose outright
        a_sp.data *= np.exp(rng.uniform(-30, 30, a_sp.nnz))
    A = pk.bt.CsrFlashMatrix.from_scipy(a_sp, val_dtype=dtype, ctx=ctx)
    out_rows, b_rows = (k, m) if transa == "T" else (m, k)
    b_np = rng.standard_normal((b_rows, n)).astype(dtype)
    c_np = rng.standard_normal((out_rows, n)).astype(dtype)
    B = pk.bt.mem_array((b_rows, n), dtype, order=order_b, data=b_np,
                        ctx=ctx)
    C = pk.bt.mem_array((out_rows, n), dtype, order=order_c, data=c_np,
                        ctx=ctx)
    pk.bt.csrmm(A, B, C, alpha=alpha, beta=beta, transa=transa, ctx=ctx)
    opa = a_sp.T if transa == "T" else a_sp
    want = alpha * (opa.astype(np.float64) @ b_np.astype(np.float64)) \
        + beta * c_np.astype(np.float64)
    tag = (f"m{m} k{k} n{n} d{density:.3f} ta{transa} ob{order_b} "
           f"a{alpha:.3f} b{beta:.3f}")
    return C.read_all().astype(np.float64), want, tag


@pytest.mark.parametrize("case", range(_N or 8))
def test_csrmm_fuzz(case, contexts):
    (ref, _, _), (got, want, tag) = (
        csrmm_case(pk, contexts[pk.name], 2000 + case, case, np.float32)
        for pk in BOTH)
    denom = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) / denom < 5e-4, tag
    assert float(np.abs(got - ref).max()) / denom < 5e-4, tag
