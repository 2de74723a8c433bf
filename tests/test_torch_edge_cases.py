"""Degenerate shapes, empty operands and scalar parameters through the
port's kernels, against bof_tpu, case for case after
tests/test_edge_cases.py: gemm with alpha 0, 1 x 1 and tall-skinny;
csrmm, csrgemv and csrcsc on empty matrices and on one dense row; sort of
one to three elements; map/reduce of one element and over a ravel view;
two gemms and a reduce on one context at once.  The port must give
bof_tpu's result (fp32 rtol 2e-4 where computed, bit for bit where
moved) and numpy's."""
import threading

import numpy as np
import pytest
import scipy.sparse as sps

from torch_pair import BOTH


@pytest.fixture
def contexts(tmp_path):
    ctxs = {pk.name: pk.context(tmp_path / f"{pk.name}_scratch")
            for pk in BOTH}
    yield ctxs
    for c in ctxs.values():
        c.destroy()


def on_both(contexts, body):
    return tuple(body(pk, contexts[pk.name]) for pk in BOTH)


def test_gemm_alpha_zero(contexts):
    rng = np.random.default_rng(0)
    a, b, c_np = (rng.standard_normal((24, 24)).astype(np.float32)
                  for _ in range(3))

    def body(pk, ctx):
        A, B, C = (pk.bt.mem_array((24, 24), np.float32, data=x, ctx=ctx)
                   for x in (a, b, c_np))
        pk.mod("ops").gemm(A, B, C, alpha=0.0, beta=1.0, blk=16, ctx=ctx)
        return C.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_allclose(port, c_np, rtol=1e-6)
    np.testing.assert_array_equal(port, ref)


def test_gemm_single_element(contexts):
    def body(pk, ctx):
        A = pk.bt.mem_array((1, 1), np.float32, data=np.array([[3.0]]),
                            ctx=ctx)
        B = pk.bt.mem_array((1, 1), np.float32, data=np.array([[4.0]]),
                            ctx=ctx)
        C = pk.bt.mem_array((1, 1), np.float32, ctx=ctx)
        pk.mod("ops").gemm(A, B, C, blk=16, ctx=ctx)
        return C.read_all()[0, 0]
    assert on_both(contexts, body) == (12.0, 12.0)


def test_gemm_tall_skinny(contexts):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((300, 5)).astype(np.float32)
    b = rng.standard_normal((5, 2)).astype(np.float32)

    def body(pk, ctx):
        A = pk.bt.mem_array((300, 5), np.float32, data=a, ctx=ctx)
        B = pk.bt.mem_array((5, 2), np.float32, data=b, ctx=ctx)
        C = pk.bt.mem_array((300, 2), np.float32, ctx=ctx)
        pk.mod("ops").gemm(A, B, C, blk=64, ctx=ctx)
        return C.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_allclose(port, a @ b, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(port, ref, rtol=2e-4, atol=1e-4)


def test_csrmm_empty_matrix(contexts):
    b = np.random.default_rng(0).standard_normal((30, 8)).astype(np.float32)

    def body(pk, ctx):
        A = pk.bt.CsrFlashMatrix.from_scipy(
            sps.csr_matrix((40, 30), dtype=np.float32), ctx=ctx)
        B = pk.bt.mem_array((30, 8), np.float32, data=b, ctx=ctx)
        C = pk.bt.mem_array((40, 8), np.float32,
                            data=np.ones((40, 8), np.float32), ctx=ctx)
        pk.bt.csrmm(A, B, C, beta=0.5, ctx=ctx)
        return C.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_allclose(port, 0.5 * np.ones((40, 8)), rtol=1e-6)
    np.testing.assert_array_equal(port, ref)


def test_csrgemv_empty_matrix(contexts):
    def body(pk, ctx):
        A = pk.bt.CsrFlashMatrix.from_scipy(
            sps.csr_matrix((10, 7), dtype=np.float32), ctx=ctx)
        return (pk.bt.csrgemv(A, np.ones(7, np.float32), ctx=ctx),
                pk.bt.csrgemv(A, np.ones(10, np.float32), trans="T",
                              ctx=ctx))
    ref, port = on_both(contexts, body)
    np.testing.assert_array_equal(port[0], np.zeros(10, np.float32))
    np.testing.assert_array_equal(port[1], np.zeros(7, np.float32))
    for r, p in zip(ref, port):
        assert p.dtype == r.dtype and p.shape == r.shape


def test_csrcsc_empty_matrix(contexts):
    def body(pk, ctx):
        A = pk.bt.CsrFlashMatrix.from_scipy(
            sps.csr_matrix((12, 9), dtype=np.float32), ctx=ctx)
        At = pk.mod("sparse").csrcsc_scratch(A, ctx=ctx)
        return At.nnz, At.shape, At.ia.read_all()
    ref, port = on_both(contexts, body)
    assert port[:2] == ref[:2] == (0, (9, 12))
    np.testing.assert_array_equal(port[2], np.zeros(10, np.int64))
    np.testing.assert_array_equal(port[2], ref[2])


def test_csrmm_single_dense_row(contexts):
    """One row holds every nonzero, far past the nnz budget (ELL range
    splitting)."""
    rng = np.random.default_rng(0)
    m, k, n = 50, 400, 16
    dense = np.zeros((m, k), np.float32)
    dense[7] = rng.standard_normal(k).astype(np.float32)
    a_sp = sps.csr_matrix(dense)
    b = rng.standard_normal((k, n)).astype(np.float32)

    def body(pk, ctx):
        ctx.config.max_nnzs = 64
        A = pk.bt.CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        B = pk.bt.mem_array((k, n), np.float32, data=b, ctx=ctx)
        C = pk.bt.mem_array((m, n), np.float32, ctx=ctx)
        pk.bt.csrmm(A, B, C, ctx=ctx)
        return C.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_allclose(port, dense @ b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port, ref, rtol=2e-4, atol=1e-4)


def test_sort_tiny(contexts):
    def body(pk, ctx):
        outs = []
        for n in (1, 2, 3):
            src = pk.bt.mem_array((n,), np.float32,
                                  data=np.arange(n, 0, -1, dtype=np.float32),
                                  ctx=ctx)
            dst = pk.bt.mem_array((n,), np.float32, ctx=ctx)
            pk.bt.bof_sort(src, dst, blk_elems=4096, ctx=ctx)
            outs.append(dst.read_all())
        return outs
    ref, port = on_both(contexts, body)
    for n, r, p in zip((1, 2, 3), ref, port):
        np.testing.assert_array_equal(p, np.arange(1, n + 1,
                                                   dtype=np.float32))
        np.testing.assert_array_equal(p, r)


def test_map_reduce_single_element(contexts):
    """np.sqrt maps to jnp.sqrt in bof_tpu and torch.sqrt in the port."""
    def body(pk, ctx):
        src = pk.bt.mem_array((1,), np.float32,
                              data=np.array([9.0], np.float32), ctx=ctx)
        dst = pk.bt.mem_array((1,), np.float32, ctx=ctx)
        pk.bt.bof_map(src, dst, np.sqrt, ctx=ctx)
        return dst.read_all()[0], pk.bt.bof_reduce(dst, "sum", ctx=ctx)
    assert on_both(contexts, body) == ((3.0, 3.0), (3.0, 3.0))


def test_ravel_view_map_over_matrix(contexts):
    """sqrt in place over a matrix's ravel view; torch's CPU sqrt is not
    correctly rounded (1 ulp from np.sqrt on some inputs), so both are
    held at rtol 1e-6."""
    data = np.abs(np.random.default_rng(0).standard_normal(
        (30, 20))).astype(np.float32)

    def body(pk, ctx):
        arr = pk.bt.mem_array((30, 20), np.float32, data=data, ctx=ctx)
        flat = arr.ravel_view()
        pk.bt.bof_map(flat, flat, np.sqrt, blk_elems=128, ctx=ctx)
        return arr.read_all()
    ref, port = on_both(contexts, body)
    np.testing.assert_allclose(port, np.sqrt(data), rtol=1e-6)
    np.testing.assert_allclose(port, ref, rtol=1e-6)


def test_concurrent_kernels_share_context(contexts):
    """Two gemms and a reduce at once on one context (shared tile cache,
    scheduler and I/O pool) do not interfere."""
    rng = np.random.default_rng(0)
    pairs = [(rng.standard_normal((48, 48)).astype(np.float32),
              rng.standard_normal((48, 48)).astype(np.float32))
             for _ in range(2)]
    vec = rng.standard_normal(10_000).astype(np.float32)

    def body(pk, ctx):
        mats = [tuple(pk.bt.mem_array((48, 48), np.float32, data=x, ctx=ctx)
                      for x in (a, b, None)) for a, b in pairs]
        V = pk.bt.mem_array((10_000,), np.float32, data=vec, ctx=ctx)
        results, errs = {}, []

        def run_gemm(i):
            try:
                pk.mod("ops").gemm(*mats[i], blk=16, ctx=ctx)
            except Exception as e:  # pragma: no cover
                errs.append(e)

        def run_reduce():
            try:
                results["sum"] = pk.bt.bof_reduce(V, "sum", blk_elems=1024,
                                                  ctx=ctx)
            except Exception as e:  # pragma: no cover
                errs.append(e)
        ts = [threading.Thread(target=run_gemm, args=(i,)) for i in range(2)]
        ts.append(threading.Thread(target=run_reduce))
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts), "a kernel hung"
        assert not errs, errs
        return [m[2].read_all() for m in mats], results["sum"]
    (ref_c, ref_sum), (port_c, port_sum) = on_both(contexts, body)
    for (a, b), r, p in zip(pairs, ref_c, port_c):
        np.testing.assert_allclose(p, a @ b, rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(p, r, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(port_sum, vec.astype(np.float64).sum(),
                               rtol=1e-6)
    assert port_sum == ref_sum
